"""Plan persistence and continuous batching on the card: the identities
the port holds on CPU tensors, on ``exact-cuda`` plans driven through the
PIM matmul kernel, at a reduced qwen3-4b (2 layers, d_model 256, vocab
512). Every test needs an NVIDIA GPU and nvcc and skips without them;
this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_serving.py
"""
import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import (ContinuousScheduler, ServingEngine,
                                 poisson_trace, static_generate)

pytestmark = pytest.mark.cuda

GEOMETRY = dict(num_slots=4, prompt_pad=96, max_len=104)
_PLANNED = {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _model(cuda, substrate="exact-cuda"):
    if substrate not in _PLANNED:
        cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=256,
                                             vocab=512)
        _PLANNED[substrate] = cfg, serve.plan_params_for_pim(
            lm.init_lm(cfg, 0, device=cuda),
            PimConfig(weight_bits=4, act_bits=4, substrate=substrate))
    return _PLANNED[substrate]


def _trace(cfg, shared=0):
    return poisson_trace(n=10, rate=0.7, prompt_lens=[9, 40, 80],
                         gen_lens=[2, 5, 8], vocab=cfg.vocab_size, seed=3,
                         shared_prefix_len=shared)


def _streams(res):
    return {c.request_id: (c.tokens.tolist(), c.stop_reason)
            for c in res.completions}


def test_plans_round_trip_on_the_card(cuda, tmp_path):
    cfg, planned = _model(cuda)
    engine.save_plans(str(tmp_path), planned)
    restored, _, _ = engine.load_plans(str(tmp_path))
    wq = restored["layers"]["attn"]["wq_dh"][1]
    assert wq.planes.is_cuda
    assert torch.equal(wq.planes, planned["layers"]["attn"]["wq_dh"][1]
                       .planes)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    want, _ = lm.prefill(planned, cfg, {"tokens": toks}, 32)
    got, _ = lm.prefill(restored, cfg, {"tokens": toks}, 32)
    assert torch.equal(got, want)


def test_tensor_logits_index_on_the_card(cuda):
    cfg, planned = _model(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    want, _ = lm.prefill(planned, cfg, {"tokens": toks}, 32,
                         logits_index=13)
    got, _ = lm.prefill(planned, cfg, {"tokens": toks}, 32,
                        logits_index=torch.tensor(13, device=cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(sync_every=3), dict(prefill_chunk=32),
                                dict(prefill_chunk=16, sync_every=2)],
                         ids=["window", "chunk32", "chunk16-window"])
def test_continuous_variants_equal_the_plain_run(cuda, kw):
    cfg, planned = _model(cuda)
    base = ContinuousScheduler(planned, cfg, **GEOMETRY).run(_trace(cfg))
    got = ContinuousScheduler(planned, cfg, **GEOMETRY, **kw).run(
        _trace(cfg))
    assert _streams(got) == _streams(base)


def test_prefix_cache_hit_equals_miss_on_the_card(cuda):
    cfg, planned = _model(cuda)
    geo = dict(GEOMETRY, prompt_pad=128, max_len=136)
    kw = dict(prefill_chunk=16, **geo)
    miss = ContinuousScheduler(planned, cfg, **kw).run(_trace(cfg, 32))
    hit = ContinuousScheduler(planned, cfg, prefix_cache=8, **kw).run(
        _trace(cfg, 32))
    assert hit.metrics["prefix_cache"]["hits"] >= 1
    assert _streams(hit) == _streams(miss)


def test_continuous_equals_static_at_the_slots_shapes(cuda):
    cfg, planned = _model(cuda)
    reqs = _trace(cfg)
    res = ContinuousScheduler(planned, cfg, **GEOMETRY).run(reqs)
    for r in reqs[:4]:
        want = static_generate(planned, cfg, r.tokens, r.max_new_tokens,
                               max_len=GEOMETRY["max_len"],
                               prompt_pad=GEOMETRY["prompt_pad"],
                               rows=GEOMETRY["num_slots"])
        np.testing.assert_array_equal(res.tokens_by_id()[r.request_id], want)


def test_exact_cuda_equals_exact_torch_through_the_engine(cuda):
    cfg, planned = _model(cuda)
    _, plain = _model(cuda, "exact-torch")
    got = ContinuousScheduler(planned, cfg, **GEOMETRY).run(_trace(cfg))
    want = ContinuousScheduler(plain, cfg, **GEOMETRY).run(_trace(cfg))
    assert _streams(got) == _streams(want)


def test_engine_prefill_is_one_padded_pass(cuda):
    """A whole prefill runs the padded prompt once: one B1 launch per
    projection and layer, all at M = the prompt pad."""
    from repro_torch.kernels.pim_matmul import pim_matmul
    cfg, planned = _model(cuda)
    eng = ServingEngine(planned, cfg, **GEOMETRY)
    pim_matmul.reset_launches()
    eng.prefill(np.arange(40, dtype=np.int32))
    assert pim_matmul.LAUNCHES["pim_matmul_fused"] == 7 * cfg.num_layers
