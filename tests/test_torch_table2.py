"""The port's Table-II / ADC-ablation study on the CPU at a tiny size:
the clipped-gradient SGD of ``_train`` lowers the loss, it trains the
float forward only (the parameters it returns are plain tensors), and
``_acc`` evaluates the float, fake-quantized, exact and analog routes.
The full studies (``run_table2``, ``run_adc_ablation``) run on the card
in ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.benchmarks_impl import table2
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import resnet18
from repro_torch.data.pipeline import synthetic_images
from repro_torch.models.cnn import cnn_forward, init_cnn


def _loss(params, layers, x, y):
    logits = cnn_forward(params, layers, x)
    tgt = logits.gather(1, y.long()[:, None])[:, 0]
    return float((torch.logsumexp(logits, -1) - tgt).mean())


@pytest.fixture(scope="module")
def trained():
    layers = resnet18(8, 8, width=0.125)
    x, y = (torch.from_numpy(v) for v in
            synthetic_images(0, 48, 8, 8, noise=table2.NOISE))
    params = init_cnn(layers, torch.Generator().manual_seed(0), device="cpu")
    after = table2._train(layers, params, x, y, steps=12, lr=0.2)
    return layers, params, after, x, y


def test_train_lowers_the_loss_and_returns_plain_tensors(trained):
    layers, before, after, x, y = trained
    assert _loss(after, layers, x, y) < _loss(before, layers, x, y)
    for name, p in after.items():
        for leaf in p.values():
            assert not leaf.requires_grad and bool(torch.isfinite(leaf).all())
        assert not torch.equal(p["w"], before[name]["w"])   # input untouched


def test_acc_on_every_route(trained):
    layers, _, params, x, y = trained
    accs = [table2._acc(params, layers, x, y),
            table2._acc(params, layers, x, y, quant_bits=8),
            table2._acc(params, layers, x, y, pim=PimConfig(
                weight_bits=4, act_bits=4, substrate="exact-cuda")),
            table2._acc(params, layers, x, y, pim=PimConfig(
                weight_bits=4, act_bits=4, adc_bits=3,
                substrate="analog-cuda"),
                rng=torch.Generator().manual_seed(table2.NOISE_SEED))]
    assert all(0.0 <= a <= 1.0 for a in accs)
    assert np.isclose(accs[0] * len(y), round(accs[0] * len(y)))


def test_studies_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table2.run_adc_ablation()
