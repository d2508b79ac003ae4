"""The PIM matmul's small-M route, on the CPU: the route chooser's
invariants (``small_m_grid``, ``split_ranges``) at the shapes the model
paths give it, and a plain emulation of the route's split-K combine
(uint32 partials per K split and per strip, summed in shuffled order)
against the port's plain versions and the JAX package's Pallas kernels
in interpret mode, bit for bit, wraparound included. The kernel itself
runs on the card (``tests/test_torch_cuda_kernels.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pim_matmul.pim_matmul import (pim_matmul_fused_pallas,
                                                 pim_matmul_pallas)
from repro_torch.configs import get_config
from repro_torch.core.pim import plan_from_qtensor
from repro_torch.kernels.pim_matmul import pim_matmul as kern
from repro_torch.kernels.pim_matmul.ref import (pim_matmul_fused_ref,
                                                pim_matmul_ref)
from repro_torch.quant.quantize import QTensor

SMS = 132   # an H100's streaming multiprocessors


def _hymba_decode_kn():
    """(K, N) of hymba-1.5b's seven projections as the kernel sees them:
    the plan pads the planes (``plan_from_qtensor``)."""
    cfg = get_config("hymba-1.5b")
    d, q = cfg.d_model, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    dims = {"q": (d, q), "k": (d, kv), "v": (d, kv), "o": (q, d),
            "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
            "down": (cfg.d_ff, d)}
    out = {}
    for name, (k, n) in dims.items():
        codes = QTensor(values=torch.zeros((k, n), dtype=torch.int8),
                        scale=torch.ones((1, n)), bits=4)
        out[name] = tuple(plan_from_qtensor(codes).planes.shape[1:])
    return out


HYMBA_KN = _hymba_decode_kn()


def test_hymba_padded_shapes():
    assert set(HYMBA_KN.values()) == {(2048, 1664), (2048, 384),
                                      (2048, 5504), (5632, 1664)}


@pytest.mark.parametrize("m", (1, 8, 32, 64))
@pytest.mark.parametrize("proj", sorted(HYMBA_KN))
def test_hymba_decode_takes_small_m_route(proj, m):
    """Every decode projection of hymba (batch m) takes the small-M route
    with at least one block per SM where K allows, within the cluster
    limits."""
    k, n = HYMBA_KN[proj]
    route, strip, splits = kern.small_m_grid(m, k, n)
    assert route == "small_m" and strip in (32, 64)
    assert 1 <= splits <= (kern.SMALL_M_MAX_SPLITS if m <= 32
                           else kern.SMALL_M_WIDE_SPLITS)
    blocks = -(-n // strip) * splits
    assert blocks <= kern.SMALL_M_MAX_BLOCKS
    if m <= 32:
        assert blocks >= SMS


@pytest.mark.parametrize("m,k,n,route", (
    (128, 512, 100, "mma_sync"), (4096, 2048, 1664, "wgmma"),
    (4096, 5632, 1664, "wgmma"), (65, 2048, 384, "wgmma"),
    (131072, 1024, 64, "wgmma"), (0, 16, 16, "wgmma")))
def test_large_m_keeps_tiled_route(m, k, n, route):
    """ResNet18's fc (M = 128), its convolutions and every prefill launch
    stay on a tiled route, and so does an empty M: the wgmma route where
    TMA can describe the planes, the mma.sync route for fc's N = 100."""
    assert kern.small_m_grid(m, k, n) == (route, 0, 0)


@pytest.mark.parametrize("m,k,n", (
    (8, 2048, 1664), (8, 2048, 384), (8, 5632, 1664), (64, 5632, 1664),
    (1, 1, 1), (7, 333, 77), (5, 129, 3000), (3, 127, 40),
    (16, 5000, 100), (33, 100, 3000), (2, 0, 8)))
def test_splits_cover_k_exactly(m, k, n):
    """The K ranges are contiguous from 0 to K, none empty, each a whole
    number of stages but the last."""
    _, _, splits = kern.small_m_grid(m, k, n)
    ranges = kern.split_ranges(k, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo % kern.SMALL_M_BK == 0
    if k:
        assert all(hi > lo for lo, hi in ranges)


def _split_k_emulation(a, w, strip, splits, rng):
    """The small-M route's arithmetic without the card: per strip of
    ``strip`` columns and per K range of ``split_ranges``, the shift-added
    uint32 partial of that block; the blocks of a strip combined in a
    shuffled order, mod 2^32, then read as int32."""
    pa, m, k = a.shape
    pw, _, n = w.shape
    a64, w64 = a.astype(np.int64), w.astype(np.int64)
    out = np.zeros((m, n), np.uint64)
    for s0 in range(0, n, strip):
        cols = slice(s0, min(n, s0 + strip))
        parts = []
        for lo, hi in kern.split_ranges(k, splits):
            part = np.zeros((m, cols.stop - s0), np.int64)
            for d in range(pa):
                for e in range(pw):
                    part += (a64[d, :, lo:hi] @ w64[e, lo:hi, cols]) \
                        << (4 * (d + e))
            parts.append((part & 0xFFFFFFFF).astype(np.uint64))
        acc = np.zeros_like(parts[0])
        for i in rng.permutation(len(parts)):
            acc = (acc + parts[i]) & 0xFFFFFFFF
        out[:, cols] = acc
    return out.astype(np.uint32).view(np.int32)


def _planes(rng, pa, pw, m, k, n, lo=-128, hi=128):
    return (rng.integers(lo, hi, size=(pa, m, k)).astype(np.int8),
            rng.integers(lo, hi, size=(pw, k, n)).astype(np.int8))


@pytest.mark.parametrize("pa,pw", ((1, 1), (1, 2), (2, 1), (2, 2)))
@pytest.mark.parametrize("m,k,n", ((7, 333, 77), (1, 300, 40),
                                   (8, 2048, 384), (13, 600, 130)))
def test_split_k_combine_bit_exact(pa, pw, m, k, n):
    """The route's combine equals the plain int32 accumulator, and with
    the epilogue the plain fused version and its row-sums, bit for bit,
    and JAX's Pallas kernel; any order of the partial sums gives the same
    bits."""
    rng = np.random.default_rng(m * k + n + pa + 2 * pw)
    a, w = _planes(rng, pa, pw, m, k, n)
    _, strip, splits = kern.small_m_grid(m, k, n)
    acc = _split_k_emulation(a, w, strip, splits, rng)
    np.testing.assert_array_equal(
        acc, _split_k_emulation(a, w, strip, splits, rng))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    np.testing.assert_array_equal(acc, pim_matmul_ref(ta, tw).numpy())
    np.testing.assert_array_equal(acc, np.asarray(pim_matmul_pallas(
        jnp.asarray(a), jnp.asarray(w), interpret=True)))
    a_s = torch.from_numpy((rng.random((m, 1)) + 0.1).astype(np.float32))
    w_s = torch.from_numpy((rng.random((1, n)) + 0.1).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32))
    # the kernel's epilogue: two roundings, then the bias add
    fused = torch.from_numpy(acc).to(torch.float32) * a_s * w_s + bias
    want, want_rs = pim_matmul_fused_ref(ta, tw, a_s, w_s, bias,
                                         want_rowsum=True)
    assert torch.equal(fused, want)
    rowsum = (acc.astype(np.int64).sum(1) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)
    np.testing.assert_array_equal(rowsum, want_rs.numpy())


def test_split_k_combine_wraps_like_int32():
    """Same-signed full-range planes at decode's M overflow int32 in
    every output and in the partials: the combine still equals the plain
    versions and JAX's kernel, row-sums included."""
    rng = np.random.default_rng(7)
    m, k, n = 8, 1000, 70
    a, w = _planes(rng, 2, 2, m, k, n, lo=100, hi=128)
    codes = [p[0].astype(np.float64) + 16 * p[1].astype(np.float64)
             for p in (a, w)]
    assert (np.abs(codes[0] @ codes[1]) > 2 ** 31).all()
    _, strip, splits = kern.small_m_grid(m, k, n)
    assert splits > 1
    acc = _split_k_emulation(a, w, strip, splits, rng)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    np.testing.assert_array_equal(acc, pim_matmul_ref(ta, tw).numpy())
    ones_m, ones_n = np.ones((m, 1), np.float32), np.ones((1, n), np.float32)
    _, want_rs = pim_matmul_fused_ref(ta, tw, torch.from_numpy(ones_m),
                                      torch.from_numpy(ones_n),
                                      want_rowsum=True)
    _, jax_rs = pim_matmul_fused_pallas(
        *[jnp.asarray(v) for v in (a, w, ones_m, ones_n)], interpret=True,
        want_rowsum=True)
    rowsum = (acc.astype(np.int64).sum(1) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)
    np.testing.assert_array_equal(rowsum, want_rs.numpy())
    np.testing.assert_array_equal(rowsum, np.asarray(jax_rs))
