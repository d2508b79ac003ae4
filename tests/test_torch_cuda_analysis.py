"""The runtime sanitizers on the card: the decode guard is CUDA's sync
debug mode "error", it raises on a host-to-device scalar copy inside the
window and on nothing in a clean qwen3 decode dispatch, the previous mode
comes back after a window that raised, and a kernel library is loaded
from a filled compile-cache directory without ``nvcc``. Every test needs
an NVIDIA GPU and nvcc and skips without them; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_analysis.py
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitize import CompileCounter, Sanitizer
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.kernels import runtime
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.cuda.set_sync_debug_mode(0)
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode(0)


def test_guard_raises_on_a_scalar_copy_to_the_card(cuda):
    x = torch.zeros(4, device=cuda)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with Sanitizer().decode_guard(cuda):
            x + torch.tensor(1.0, device=cuda)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with Sanitizer().decode_guard(cuda):
            x.sum().item()
    # outside the window the same reads are legal
    assert (x + torch.tensor(1.0, device=cuda)).sum().item() == 4.0
    with Sanitizer().decode_guard(cuda):      # the repaired form
        y = torch.where(x > 0, x, -1e30)
    assert y.min().item() == pytest.approx(-1e30)


def test_guard_restores_the_previous_mode_after_a_raise(cuda):
    torch.cuda.set_sync_debug_mode("warn")
    with pytest.raises(RuntimeError):
        with Sanitizer().decode_guard(cuda):
            assert torch.cuda.get_sync_debug_mode() == 2
            torch.ones(1, device=cuda).item()
    assert torch.cuda.get_sync_debug_mode() == 1


@pytest.mark.parametrize("sync_every", [1, 2])
def test_clean_qwen3_decode_dispatch_raises_nothing(cuda, sync_every):
    """A reduced qwen3 on exact-cuda plans: every decode dispatch armed,
    tokens equal to the unarmed engine's."""
    cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=256,
                                         vocab=512)
    planned = serve.plan_params_for_pim(
        lm.init_lm(cfg, 0, device=cuda),
        PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda"))
    prompts = [np.arange(n, dtype=np.int32) % cfg.vocab_size
               for n in (5, 24)]

    def tokens(sanitizer):
        eng = ServingEngine(planned, cfg, num_slots=2, prompt_pad=32,
                            max_len=48, sync_every=sync_every,
                            sanitizer=sanitizer)
        eng.warmup()
        state = eng.init_state()
        for i, p in enumerate(prompts):
            state, _ = eng.insert(eng.prefill(p), state, max_new_tokens=8,
                                  request_id=i)
        out = []
        while state.slots:
            state, res = eng.generate(state)
            out += [(e.request_id, e.token) for e in res.events]
        return out

    assert tokens(Sanitizer()) == tokens(None)


def test_filled_cache_directory_loads_without_nvcc(cuda, tmp_path,
                                                   monkeypatch):
    runtime.load_library("pim_matmul")           # fills the default dir
    src = runtime.library_path("pim_matmul")
    monkeypatch.setattr(runtime, "_build_dir", runtime.build_dir())
    monkeypatch.setattr(runtime, "_LIBS", {})
    monkeypatch.setattr(runtime, "_LOADED_FROM", {})
    serve.enable_compile_cache(str(tmp_path))
    shutil.copy2(src, runtime.library_path("pim_matmul"))
    with CompileCounter(names=("nvcc:",)) as counter:
        runtime.load_library("pim_matmul")
    assert counter.counts == {}
    assert runtime.loaded_libraries() == {
        "pim_matmul": str(tmp_path.resolve() / src.name)}
