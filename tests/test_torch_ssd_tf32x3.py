"""The decomposition that the SSD scan kernel (``src/repro_torch/csrc/
ssd_scan.cu``) runs on Hopper's tensor cores, emulated in PyTorch on the
CPU, against the JAX package's ``ssd_scan_pallas`` (interpret mode) and
``ssd_scan_ref`` on the same numpy inputs.

The kernel works per (row, chunk): a chunk pass forms the scores C B^T,
keeps them where j <= i times exp(cl_i - cl_j), and writes y_intra =
scores X and the chunk's own state (B o exp(cl_last - cl))^T X; a fold
over the chunks in order, S = exp(cl_last) S + dS, gives each chunk's
starting state and the final state; an inter-chunk pass adds exp(cl_i)
(C S_start). A ragged tail is masked: x = b = c = 0, a = 1. Each of the
four contractions is 3xTF32: a float32 x is split into hi =
cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), and a b is lo(a)
hi(b) + hi(a) lo(b) + hi(a) hi(b). A product of two TF32 values is exact
in float32, so a float32 matmul of the split operands emulates the tensor
cores up to the order of the float32 sums. The emulation lives here; the
plain versions (``kernels/ssd_scan/ref.py``) stay full float32.

Tolerances:
- against JAX's kernel in interpret mode and its sequential oracle: rtol
  2e-4, atol 2e-5, the JAX package's own bound between the two (float32
  sums in another order; the split adds 2^-21 per product);
- one-product TF32, the control, must land at least 10x farther from a
  float64 evaluation of the same decomposition (largest gap relative to
  the largest |y| and |S|) than the 3xTF32 emulation does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_seq
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas

TOL = dict(rtol=2e-4, atol=2e-5)
CONTROL_FACTOR = 10
LOG_FLOOR = 1e-37

# (BH, L, P, N, chunk, decay): several chunks; a ragged tail with N and P
# not multiples of 8; long decay (a = 1e-6: exp(cl_i - cl_j) above the
# diagonal overflows); a chunk above 128; chunk = L with odd dimensions;
# mamba2-370m's state and head widths over two chunks
SHAPES = ((2, 128, 16, 8, 32, None), (2, 100, 12, 5, 32, None),
          (1, 64, 8, 8, 32, 1e-6), (1, 384, 8, 16, 192, None),
          (2, 96, 5, 3, 96, None), (1, 256, 64, 128, 128, None))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits, ties
    away from zero (a float32 is sign and magnitude: add half a TF32 ulp
    to the bits, clear the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it: lo hi + hi lo in one accumulator,
    hi hi in another, joined at the end."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: one TF32 product."""
    return to_tf32(a) @ to_tf32(b)


def ssd_on_tensor_cores(x, a, b, c, chunk, mm):
    """The kernel's decomposition with its four products through ``mm``:
    chunk pass (scores, y_intra, chunk states and decays), fold in chunk
    order, inter-chunk output. Returns y (BH, L, P) and the final state
    (BH, N, P) in the inputs' dtype."""
    bh, l, p = x.shape
    n = b.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    x, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (x, b, c))
    a = F.pad(a, (0, pad), value=1.0)
    xc = x.reshape(bh, nc, chunk, p)
    bc = b.reshape(bh, nc, chunk, n)
    cc = c.reshape(bh, nc, chunk, n)
    cl = torch.cumsum(torch.log(torch.clamp_min(a.reshape(bh, nc, chunk),
                                                LOG_FLOOR)), dim=-1)
    lower = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    zero = torch.zeros((), dtype=x.dtype)
    scores = mm(cc, bc.transpose(-1, -2))
    # selected, never masked by a multiply: above the diagonal the exp
    # may be inf
    scores = torch.where(
        lower, scores * torch.exp(cl[..., :, None] - cl[..., None, :]), zero)
    y = mm(scores, xc)
    decay_to_end = torch.exp(cl[..., -1:] - cl)
    d_states = mm((bc * decay_to_end[..., None]).transpose(-1, -2), xc)
    decay = torch.exp(cl[..., -1])
    s = torch.zeros((bh, n, p), dtype=x.dtype)
    starts = []
    for ci in range(nc):
        starts.append(s)
        s = decay[:, ci, None, None] * s + d_states[:, ci]
    y = y + torch.exp(cl)[..., None] * mm(cc, torch.stack(starts, dim=1))
    return y.reshape(bh, nc * chunk, p)[:, :l], s


def _inputs(bh, l, p, n, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, l, p))
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((bh, l)) + 2.0))) \
        if decay is None else np.full((bh, l), decay)
    b = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    c = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    return [v.astype(np.float32) for v in (x, a, b, c)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _rel_gap(got, want):
    """Largest |got - want| of y and of S, each relative to that output's
    largest |want|."""
    return max(float((g.double() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("bh,l,p,n,q,decay", SHAPES)
def test_3xtf32_decomposition_matches_jax(bh, l, p, n, q, decay):
    arrs = _inputs(bh, l, p, n, seed=l + n, decay=decay)
    got = ssd_on_tensor_cores(*(torch.from_numpy(v) for v in arrs), q,
                              mm_3xtf32)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    ja = [jnp.asarray(v) for v in arrs]
    _close(got, j_seq(*ja))
    if l % q == 0:
        _close(got, ssd_scan_pallas(*ja, chunk=q, interpret=True))


@pytest.mark.parametrize("bh,l,p,n,q,decay", SHAPES)
def test_one_product_tf32_control_lands_farther(bh, l, p, n, q, decay):
    arrs = _inputs(bh, l, p, n, seed=l + n + 1, decay=decay)
    t32 = [torch.from_numpy(v) for v in arrs]
    want = ssd_on_tensor_cores(*(t.double() for t in t32), q, torch.matmul)
    gap3 = _rel_gap(ssd_on_tensor_cores(*t32, q, mm_3xtf32), want)
    gap1 = _rel_gap(ssd_on_tensor_cores(*t32, q, mm_tf32), want)
    assert gap3 * CONTROL_FACTOR <= gap1, (gap3, gap1)


def test_emulated_split_drops_at_most_2_to_the_minus_21():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) | lo.view(torch.int32))
                 & 0x1FFF == 0).all())
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -21 * x.double().abs()).all())
