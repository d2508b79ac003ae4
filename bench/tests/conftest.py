"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the path, and cells cut to sizes a CPU holds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# sizes a test run can hold; every width of the cell's configuration cut
TINY_CNN = dict(image_hw=8, stem_channels=8, stages=[[8, 1], [16, 1]],
                num_classes=10)
TINY_CNN_TRAFFIC = dict(batch=4, check_batches=4, trace_batches=2)
TINY_LM = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=500)
TINY_LM_TRAFFIC = dict(clients=2, prompt_pad=64, block=4, backlog=400,
                       prompt={"dist": "log_uniform", "lo": 8, "hi": 64},
                       output={"dist": "uniform", "lo": 2, "hi": 4},
                       warm_completions=2, check_requests=3,
                       check_among=6)


def tiny(workload: str, model=None, traffic=None):
    """The cell ``workload`` with its model and traffic cut to CPU
    sizes."""
    from bench import harness
    cell = harness.Cell(workload)
    cnn = cell.config["driver"] == "cnn"
    cell.config["model"].update(model or (TINY_CNN if cnn else TINY_LM))
    cell.traffic.update(traffic or (TINY_CNN_TRAFFIC if cnn
                                    else TINY_LM_TRAFFIC))
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
