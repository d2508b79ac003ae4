"""MoE on the card: expert-stacked plans driven through the PIM matmul
kernel (``exact-cuda``) and the analog kernels (``analog-cuda``) against
their plain substrates, at moonshot-v1-16b-a3b's expert shapes. Every
test needs an NVIDIA GPU and nvcc and skips without them; this file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.kernels.analog_readout import analog_readout
from repro_torch.kernels.pim_matmul import pim_matmul
from repro_torch.launch import serve
from repro_torch.models import lm, moe

pytestmark = pytest.mark.cuda

# moonshot-v1-16b-a3b's expert (K, N): up/gate, down (K = 1408 planned
# to 1536); a few of its 64 experts
MOE_KN = ((2048, 1408), (1408, 2048))
EXPERTS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def _routed(plan, substrate):
    return dataclasses.replace(plan, dense=dataclasses.replace(
        plan.dense, cfg=dataclasses.replace(plan.cfg, substrate=substrate)))


@pytest.mark.parametrize("paired", (False, True))
@pytest.mark.parametrize("m", (8, 4096))
@pytest.mark.parametrize("k,n", MOE_KN)
def test_exact_cuda_experts_bit_exact(cuda, k, n, m, paired):
    """One kernel launch per expert, on the route the chooser gives M
    (small-M at 8 rows, wgmma at 4096), equal to ``exact-torch``."""
    plan = engine.program(_rand((EXPERTS, k, n), 0, cuda),
                          PimConfig(substrate="exact-cuda"), kind="experts")
    x = _rand((EXPERTS, m, k) if paired else (m, k), 1, cuda)
    before = pim_matmul.LAUNCHES["pim_matmul_fused"]
    got = engine.matmul(x, plan, paired=paired)
    torch.cuda.synchronize()
    assert pim_matmul.LAUNCHES["pim_matmul_fused"] - before == EXPERTS
    want = engine.matmul(x, _routed(plan, "exact-torch"), paired=paired)
    assert got.shape == (EXPERTS, m, n)
    assert torch.equal(got, want)


@pytest.mark.filterwarnings("ignore:analog readout without an rng")
@pytest.mark.parametrize("paired", (False, True))
def test_analog_cuda_experts_equal_analog(cuda, paired):
    """Each expert auto-ranges on its own: B3 and B4 launch once per
    expert, and the result equals the plain ``analog`` substrate."""
    k, n, m = 1408, 512, 64
    plan = engine.program(_rand((EXPERTS, k, n), 2, cuda),
                          PimConfig(substrate="analog-cuda"), kind="experts")
    x = _rand((EXPERTS, m, k) if paired else (m, k), 3, cuda)
    before = dict(analog_readout.LAUNCHES)
    got = engine.matmul(x, plan, paired=paired)
    torch.cuda.synchronize()
    assert all(analog_readout.LAUNCHES[name] - before[name] == EXPERTS
               for name in before)
    want = engine.matmul(x, _routed(plan, "analog"), paired=paired)
    assert torch.equal(got, want)


def test_moe_pim_exact_cuda_equals_exact_torch(cuda):
    """The PIM MoE FFN at moonshot's widths on 8 experts, in chunks and
    whole, ``exact-cuda`` bit for bit against ``exact-torch``."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(gen, 2048, 8, 1408, device=cuda)
    cfg = PimConfig(substrate="exact-cuda")
    plans = {n: engine.program(p[n], cfg, kind="experts")
             for n in ("wi_edf", "wg_edf", "wo_efd")}
    x = _rand((512, 2048), 4, cuda)
    probs, ids, _, _ = moe._route(p["router_de"], x, 6)
    got = moe._moe_pim(x, probs, ids, *plans.values())
    want = moe._moe_pim(x, probs, ids, *(_routed(v, "exact-torch")
                                         for v in plans.values()))
    assert torch.equal(got, want)
    limit = moe.PIM_CHUNK_ELEMENTS
    try:
        moe.PIM_CHUNK_ELEMENTS = 512 * 2048 * 3     # chunks of 3, 3, 2
        chunked = moe._moe_pim(x, probs, ids, *plans.values())
    finally:
        moe.PIM_CHUNK_ELEMENTS = limit
    torch.testing.assert_close(chunked, got, rtol=1e-5, atol=1e-6)


def test_moonshot_reduced_serving_exact_cuda_equals_exact_torch(cuda):
    """moonshot-v1-16b-a3b at 2 layers and d_model 256, programmed as
    serving does it: prefill and two decode steps, ``exact-cuda`` logits
    equal to ``exact-torch``'s; 4 + 3 + 3 * 8 launches per layer."""
    cfg, params, _, _, _ = serve._setup("moonshot-v1-16b-a3b", 2, 256, True,
                                        4, False, "exact-cuda", None)
    assert cfg.is_moe and cfg.num_experts == 8
    plain = _restamp(params, "exact-torch")
    toks = torch.randint(0, cfg.vocab_size, (4, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = pim_matmul.LAUNCHES["pim_matmul_fused"]
    logits, cache = lm.prefill(params, cfg, {"tokens": toks}, 18)
    torch.cuda.synchronize()
    assert pim_matmul.LAUNCHES["pim_matmul_fused"] - before == \
        cfg.num_layers * (4 + 3 + 3 * cfg.num_experts)
    want, pcache = lm.prefill(plain, cfg, {"tokens": toks}, 18)
    assert torch.equal(logits, want)
    for i in range(2):
        tok = logits.argmax(-1)[:, None]
        logits, cache = lm.decode_step(params, cfg, cache, tok, 16 + i)
        want, pcache = lm.decode_step(plain, cfg, pcache, tok, 16 + i)
        assert torch.equal(logits, want)
    assert get_config("moonshot-v1-16b-a3b").num_experts == 64


def _restamp(tree, substrate):
    if isinstance(tree, dict):
        return {k: _restamp(v, substrate) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_routed(p, substrate) if hasattr(p, "dense") else
                dataclasses.replace(p, cfg=dataclasses.replace(
                    p.cfg, substrate=substrate)) for p in tree]
    return tree
