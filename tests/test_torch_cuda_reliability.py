"""ABFT verification on the card: B1's row-sum epilogue as the exact
check's probe on every route, ``exact-cuda``'s violation counts against
``exact-torch``'s, no host sync added by verification, and a fused
window's replay after a violation. Every
test needs an NVIDIA GPU and nvcc and skips without them; this file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_reliability.py
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.kernels.pim_matmul import pim_matmul as kern
from repro_torch.kernels.pim_matmul import ref
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.quant.nibbles import to_nibbles
from repro_torch.quant.quantize import quantize
from repro_torch.reliability import (FAULT_LOG, FaultModel,
                                     ReliabilityManager, ReliabilityPolicy,
                                     abft, inject_tree)
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    FAULT_LOG.clear()
    yield torch.device("cuda")
    FAULT_LOG.clear()


# (M, K, N): the wgmma route, the mma.sync route (N % 16 != 0), small-M
ROUTE_SHAPES = {"wgmma": (512, 2560, 1024), "mma_sync": (96, 512, 100),
                "small_m": (8, 9728, 2560)}


@pytest.mark.parametrize("route", sorted(ROUTE_SHAPES))
def test_rowsum_is_the_checksum_matvec_on_every_route(cuda, route):
    """B1's int32 row-sums equal the plain version's and satisfy the
    checksum identity against the codes' record (unpadded planes, so the
    mma.sync route's N % 16 != 0 is reachable); a changed row-sum is one
    violation."""
    m, k, n = ROUTE_SHAPES[route]
    gen = torch.Generator(device=cuda).manual_seed(1)
    w_q = quantize(torch.randn((k, n), generator=gen, device=cuda), bits=4,
                   axis=(0,))
    a_q = quantize(torch.randn((m, k), generator=gen, device=cuda), bits=4,
                   axis=(1,))
    a_planes = to_nibbles(a_q.values, 4).contiguous()
    w_planes = to_nibbles(w_q.values, 4).contiguous()
    w_scale = w_q.scale.to(torch.float32).reshape(1, n).contiguous()
    record = abft.checksums(w_q.values, w_q.scale)
    assert kern.small_m_grid(m, k, n)[0] == route
    kern.reset_launches()
    out, rowsum = kern.pim_matmul_fused_cuda(a_planes, w_planes, a_q.scale,
                                             w_scale, want_rowsum=True)
    assert kern.ROWSUM_LAUNCHES[route] == 1
    want, want_rs = ref.pim_matmul_fused_ref(
        a_planes.cpu(), w_planes.cpu(), a_q.scale.cpu(), w_scale.cpu(),
        want_rowsum=True)
    assert torch.equal(rowsum.cpu(), want_rs) and torch.equal(out.cpu(), want)
    check = lambda rs: int(abft.int_violations(
        rs, a_q.values, record, w_q.scale, mode="always"))
    assert check(rowsum) == 0
    bad = rowsum.clone()
    bad[m // 2] += 1
    assert check(bad) == 1


@pytest.mark.parametrize("mode", ["sample", "always"])
def test_exact_cuda_counts_equal_exact_torch(cuda, mode):
    gen = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn((384, 200), generator=gen, device=cuda)
    x = torch.randn((24, 384), generator=gen, device=cuda)
    spec = [FaultModel(seed=3, bitflips=2, stuck_planes=1, stuck_value=15,
                       dropped_chunks=1, adc_gain=1.05)]
    counts = {}
    for substrate in ("exact-cuda", "exact-torch"):
        plan = engine.program(w, PimConfig(substrate=substrate, verify=mode,
                                           abft_tag="t"))
        for kind, p in (("clean", plan),
                        ("faulty", inject_tree(plan, spec, _path="p")[0])):
            FAULT_LOG.clear()
            y = engine.matmul(x, p)
            snap = FAULT_LOG.snapshot()
            counts[(substrate, kind)] = (snap["violation_rows"],
                                         snap["total_violations"],
                                         y.cpu())
    for kind in ("clean", "faulty"):
        a, b = counts[("exact-cuda", kind)], counts[("exact-torch", kind)]
        assert a[:2] == b[:2] and torch.equal(a[2], b[2]), kind
    assert counts[("exact-cuda", "clean")][1] == 0
    assert counts[("exact-cuda", "faulty")][1] == 1


def _syncs(fn):
    """``fn()`` and the number of synchronizing CUDA calls it made, as
    torch's sync debug mode reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def test_verified_matmuls_in_a_scope_add_no_sync(cuda):
    """Verified ``exact-cuda`` matmuls inside a collect scope, the scope's
    close (the per-tag sums) included, make no synchronizing call, as the
    same matmuls unverified make none: the counts wait on the device."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    w = torch.randn((512, 384), generator=gen, device=cuda)
    x = torch.randn((8, 512), generator=gen, device=cuda)
    plans = {verify: [engine.program(w, PimConfig(
        substrate="exact-cuda", verify=verify, abft_tag=tag))
        for tag in ("a", "b", "a")] for verify in ("off", "always")}

    def run(verify):
        with abft.collect_scope() as scope:
            ys = [engine.matmul(x, p) for p in plans[verify]]
        return ys, scope

    for verify in plans:            # builds and loads the kernel
        run(verify)
    (y_off, _), n_off = _syncs(lambda: run("off"))
    (y_on, scope), n_on = _syncs(lambda: run("always"))
    assert n_on == n_off == 0
    assert scope.names == ("a", "b") and scope.counts().is_cuda
    assert scope.counts().tolist() == [0, 0]
    assert all(torch.equal(a, b) for a, b in zip(y_on, y_off))


def test_verified_decode_dispatch_adds_no_sync(cuda):
    """One decode dispatch of an armed engine makes as many synchronizing
    calls as the verify-off engine's: the per-tag counts come back in the
    dispatch's one copy of its tokens, and are delivered there."""
    cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=256,
                                         vocab=512)
    params = lm.init_lm(cfg, 0, device=cuda)
    prompt = np.arange(24, dtype=np.int32) % cfg.vocab_size

    def decode_syncs(verify, reliability):
        planned = serve.plan_params_for_pim(
            params, PimConfig(weight_bits=4, act_bits=4, verify=verify))
        man = ReliabilityManager(planned) if reliability else None
        eng = ServingEngine(planned, cfg, num_slots=2, prompt_pad=32,
                            max_len=48, reliability=man)
        state = eng.init_state()
        state, _ = eng.insert(eng.prefill(prompt), state, max_new_tokens=8)
        state, _ = eng.generate(state)          # the first call's costs
        FAULT_LOG.clear()
        (_, res), n = _syncs(lambda: eng.generate(state))
        return [(e.slot, e.token) for e in res.events], n

    want, n_off = decode_syncs("off", False)
    got, n_on = decode_syncs("always", True)
    assert got == want and n_on == n_off
    assert FAULT_LOG.snapshot()["total_checks"] > 0


def test_window_replay_is_bit_identical(cuda):
    """sync_every 4 with a transient fault that trips every dispatch:
    each window is replayed on the exact-cuda fallback from the restored
    pre-dispatch cache; tokens and the slot cache equal the fault-free
    engine's after every window."""
    cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=256,
                                         vocab=512)
    planned = serve.plan_params_for_pim(
        lm.init_lm(cfg, 0, device=cuda),
        PimConfig(weight_bits=4, act_bits=4, verify="always"))
    man = ReliabilityManager(
        planned, [FaultModel(target="layers/mlp/*", seed=4, stuck_planes=2,
                             stuck_value=15, sticky=False)],
        ReliabilityPolicy(repair_after=10 ** 6))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (40, 64, 17)]

    def serve_all(**kw):
        eng = ServingEngine(planned, cfg, num_slots=4, prompt_pad=64,
                            max_len=80, sync_every=4, **kw)
        state = eng.init_state()
        for i, p in enumerate(prompts):
            state, _ = eng.insert(eng.prefill(p), state,
                                  max_new_tokens=10 + i)
        out = []
        while state.slots:
            state, res = eng.generate(state)
            out.append(([(e.slot, e.token) for e in res.events],
                        {k: v.clone() for k, v in state.cache.items()}))
        return out

    want = serve_all()
    got = serve_all(reliability=man)
    assert len(got) == len(want) and man.retries >= len(want)
    for (ge, gc), (we, wc) in zip(got, want):
        assert ge == we
        for key in ("k", "v"):
            assert torch.equal(gc[key], wc[key]), key
