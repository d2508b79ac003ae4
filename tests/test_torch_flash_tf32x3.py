"""The 3xTF32 split that the flash kernels (the forward and the dQ and
dK/dV passes) run on Hopper's tensor cores
(``src/repro_torch/csrc/mma_tf32x3.cuh``), emulated in PyTorch on the CPU.

A float32 x is split into hi = cvt.rna.tf32.f32(x) and lo =
cvt.rna.tf32.f32(x - hi); each product a b is lo(a) hi(b) + hi(a) lo(b) +
hi(a) hi(b) into float32. A product of two TF32 values is exact in
float32, so a float32 matmul of the split operands emulates the tensor
cores up to the order of the float32 sums. The emulation lives here; the
plain version (``kernels/flash_attention/ref.py``) stays full float32.

Tolerances:
- the rounding: exact, bit for bit, at ties, negatives and powers of two;
- the split: |x - (hi + lo)| <= 2^-21 |x| (lo keeps 11 bits of a
  remainder below half a TF32 ulp of x);
- the dK/dV and the dQ math on split operands against the float32 plain
  version: within 1e-5 of each gradient's largest magnitude (float32 sums
  of up to S * rep terms in another order, plus the split's 2^-21 per
  product; the kernels' own bound against the plain version on the card is
  1e-3), and one-product TF32, the control, at least 10x farther;
- against ``jax.grad`` of the JAX package's reference: rtol 1e-4, atol
  1e-5, as ``tests/test_torch_flash.py`` holds the port's gradients;
- the forward (its tiles, the split, per-tile O fragments joined by
  float32 multiply-adds, logits scaled after the product) against the
  plain version and JAX's ``flash_attention_pallas`` in interpret mode:
  rtol 2e-4, atol 2e-5, the JAX kernel test's bound, which one-product
  TF32, the control, misses.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import ref as t_ref

# (b, s, h, kv, d, causal, window, prefix): GQA with a window
SHAPE = (1, 128, 4, 1, 64, True, 40, 0)
SPLIT_REL = 1e-5
CONTROL_FACTOR = 10
FWD = dict(rtol=2e-4, atol=2e-5)
# the forward's cases: a ragged S for its 64-query blocks and 32-key tiles
# (rows past S, a part-filled warp), GQA, a window, a prefix, both, no
# causal mask, and head dims the kernel pads (16, 40)
FWD_CASES = [
    (1, 100, 4, 1, 64, True, 0, 0),
    (1, 100, 2, 2, 40, True, 30, 5),
    (2, 77, 4, 2, 32, False, 20, 0),
    (1, 128, 4, 2, 16, True, 0, 24),
    (1, 160, 2, 1, 128, True, 48, 0),
]
FWD_BQ, FWD_BK, FWD_ROWS = 64, 32, 16   # block rows, key tile, warp rows


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits, ties
    away from zero; the low 13 bits of the result are zero. A float32 is
    sign and magnitude, so adding half a TF32 ulp to the bits and clearing
    the low 13 rounds the magnitude, carrying into the exponent."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it: lo hi + hi lo first, then hi hi."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: one TF32 product."""
    return to_tf32(a) @ to_tf32(b)


def dkv_on_tensor_cores(q, k, v, lse, delta, dout, causal, window, prefix,
                        mm):
    """flash_attention_bwd_dkv_ref's math with its four products through
    ``mm``, in the kernel's order: S^T = K Q^T and dP^T = V dO^T, then
    P^T and dS^T, then dV = P^T dO and dK = dS^T Q / sqrt(d)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s)
    qp, kp = pos[None, :], pos[:, None]          # (key, query) layout
    ok = (qp >= kp) if causal else torch.ones((s, s), dtype=torch.bool)
    ok = ok | (kp < prefix)
    if window > 0:
        ok = ok & (((qp - kp) < window) | (kp < prefix))
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    for bi in range(b):
        for hd in range(h):
            kh = k[bi, :, hd // rep]
            vh = v[bi, :, hd // rep]
            qh, doh = q[bi, :, hd], dout[bi, :, hd]
            st = mm(kh, qh.T) * scale
            dpt = mm(vh, doh.T)
            pt = torch.where(ok, torch.exp(st - lse[bi, hd][None, :]),
                             torch.zeros(()))
            dst = pt * (dpt - delta[bi, hd][None, :])
            dv[bi, :, hd] = mm(pt, doh)
            dk[bi, :, hd] = mm(dst, qh) * scale
    return dk, dv


def dq_on_tensor_cores(q, k, v, o, lse, dout, causal, window, prefix, mm):
    """flash_attention_bwd_dq_ref's math with its three products through
    ``mm``, in the kernel's order: S = Q K^T and dP = dO V^T, then P and
    dS, then dQ = dS K; S and dQ scaled by 1/sqrt(d) after the product, as
    the kernel does (it copies Q unscaled)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s)
    qp, kp = pos[:, None], pos[None, :]          # (query, key) layout
    ok = (qp >= kp) if causal else torch.ones((s, s), dtype=torch.bool)
    ok = ok | (kp < prefix)
    if window > 0:
        ok = ok & (((qp - kp) < window) | (kp < prefix))
    delta = (dout * o).sum(-1).transpose(1, 2)
    dq = torch.empty_like(q)
    for bi in range(b):
        for hd in range(h):
            kh = k[bi, :, hd // rep]
            vh = v[bi, :, hd // rep]
            qh, doh = q[bi, :, hd], dout[bi, :, hd]
            sc = mm(qh, kh.T) * scale
            dp = mm(doh, vh.T)
            p = torch.where(ok, torch.exp(sc - lse[bi, hd][:, None]),
                            torch.zeros(()))
            ds = p * (dp - delta[bi, hd][:, None])
            dq[bi, :, hd] = mm(ds, kh) * scale
    return dq


def _padded_dim(d):
    """The kernel's column count: D padded with zeros to 32, 64, 128 or
    256."""
    return next(w for w in (32, 64, 128, 256) if d <= w)


def _tile_live(q0, nq, k0, nk, s, causal, window, prefix):
    """The kernel's tile_live: false only when every pair is masked."""
    if k0 < prefix:
        return True
    qlast, klast = min(q0 + nq, s) - 1, min(k0 + nk, s) - 1
    if causal and k0 > qlast:
        return False
    return not (window > 0 and q0 - klast >= window)


def fwd_on_tensor_cores(q, k, v, causal, window, prefix, mm):
    """The forward kernel's arithmetic: per head, blocks of FWD_BQ query
    rows visit the live key tiles of FWD_BK keys in order; each warp's
    FWD_ROWS rows skip the tiles wholly masked for them. Per tile: S = Q K^T
    over the padded columns in two halves joined by a float32 add, scaled by
    1/sqrt(d) after the product, masked to -1e30; the online softmax; P V
    into a fresh tile sum that joins the running O as O alpha + tile. Every
    product goes through ``mm``. Returns o (b, s, h, d) and lse (b, h,
    s)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    dv = _padded_dim(d)
    pad = lambda t: torch.nn.functional.pad(t, (0, dv - d))
    qp, kp, vp = pad(q), pad(k), pad(v)
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d)))
    neg = torch.tensor(-1e30)
    o = torch.zeros((b, s, h, dv))
    lse = torch.zeros((b, h, s))
    for bi in range(b):
        for hd in range(h):
            kh, vh = kp[bi, :, hd // rep], vp[bi, :, hd // rep]
            for q0 in range(0, s, FWD_BQ):
                tiles = [k0 for k0 in range(0, s, FWD_BK) if _tile_live(
                    q0, FWD_BQ, k0, FWD_BK, s, causal, window, prefix)]
                for r0 in range(q0, min(q0 + FWD_BQ, s), FWD_ROWS):
                    rows = torch.arange(r0, min(r0 + FWD_ROWS, s))
                    qh = qp[bi, rows, hd]
                    m = torch.full((len(rows),), -1e30)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros((len(rows), dv))
                    for k0 in tiles:
                        if not _tile_live(r0, FWD_ROWS, k0, FWD_BK, s,
                                          causal, window, prefix):
                            continue
                        keys = torch.arange(k0, min(k0 + FWD_BK, s))
                        kt, vt = kh[keys], vh[keys]
                        half = dv // 2
                        sc = (mm(qh[:, :half], kt[:, :half].T)
                              + mm(qh[:, half:], kt[:, half:].T)) * scale
                        ok = (rows[:, None] >= keys[None, :]) if causal \
                            else torch.ones((len(rows), len(keys)),
                                            dtype=torch.bool)
                        ok = ok | (keys[None, :] < prefix)
                        if window > 0:
                            ok = ok & (((rows[:, None] - keys[None, :])
                                        < window) | (keys[None, :] < prefix))
                        sc = torch.where(ok, sc, neg)
                        mx = torch.maximum(m, sc.max(-1).values)
                        alpha = torch.exp(m - mx)
                        p = torch.exp(sc - mx[:, None])
                        l = l * alpha + p.sum(-1)
                        m = mx
                        acc = acc * alpha[:, None] + mm(p, vt)
                    denom = torch.clamp(l, min=1e-37)
                    o[bi, rows, hd] = acc / denom[:, None]
                    lse[bi, hd, rows] = m + torch.log(denom)
    return o[..., :d], lse


def _fwd_inputs(shape, seed):
    b, s, h, kv, d = shape[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _fwd_ids(shape):
    return "b{}s{}h{}kv{}d{}c{}w{}p{}".format(*[int(x) for x in shape])


@pytest.mark.parametrize("shape", FWD_CASES, ids=_fwd_ids)
def test_fwd_split_products_match_the_plain_version(shape):
    """The forward's arithmetic on split operands lies within the JAX
    kernel test's rtol 2e-4, atol 2e-5 of the float32 plain version, o and
    the log-sum-exp both; one-product TF32, the control, does not."""
    mask = shape[5:]
    q, k, v = map(torch.from_numpy, _fwd_inputs(shape, seed=sum(shape[:5])))
    want = t_ref.flash_attention_ref(q, k, v, *mask)
    b, s, h = shape[:3]
    want_lse = torch.logsumexp(t_ref._logits(q, k, *mask), -1).reshape(
        b, h, s)
    got, lse = fwd_on_tensor_cores(q, k, v, *mask, mm=mm_3xtf32)
    torch.testing.assert_close(got, want, **FWD)
    torch.testing.assert_close(lse, want_lse, **FWD)
    control, _ = fwd_on_tensor_cores(q, k, v, *mask, mm=mm_tf32)
    assert not torch.allclose(control, want, **FWD), \
        (control - want).abs().max().item()


@pytest.mark.parametrize("shape", FWD_CASES, ids=_fwd_ids)
def test_fwd_split_products_match_jax_pallas(shape):
    """The same arithmetic against the JAX package's Pallas kernel in
    interpret mode (one block over the whole sequence: its blocks must
    divide S) within rtol 2e-4, atol 2e-5."""
    mask = shape[5:]
    arrays = _fwd_inputs(shape, seed=sum(shape[:5]) + 1)
    want = flash_attention_pallas(*arrays, *mask, interpret=True)
    got, _ = fwd_on_tensor_cores(*map(torch.from_numpy, arrays), *mask,
                                 mm=mm_3xtf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _inputs(seed=0):
    b, s, h, kv, d, causal, win, pre = SHAPE
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                            (b, s, h, d))]
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    mask = (causal, win, pre)
    lse = torch.logsumexp(t_ref._logits(q, k, *mask), -1).reshape(b, h, s)
    o = t_ref.flash_attention_ref(q, k, v, *mask)
    _, delta = t_ref.flash_attention_bwd_dq_ref(q, k, v, o, lse, dout, *mask)
    return arrays, (q, k, v, lse, delta, dout), mask


def _dq_inputs(seed=0):
    """The dQ pass's inputs: q, k, v, the forward's output and
    log-sum-exp, and dout."""
    arrays, (q, k, v, lse, _, dout), mask = _inputs(seed)
    return arrays, (q, k, v, t_ref.flash_attention_ref(q, k, v, *mask), lse,
                    dout), mask


def _f32(x):
    return np.array([x], dtype=np.float32)


# (input, cvt.rna.tf32.f32 of it): a TF32 ulp at 1 is 2^-10
ROUNDING = [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),      # negative tie
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # just below the tie
    (1.0 + 2.0 ** -11 + 2.0 ** -23, 1.0 + 2.0 ** -10),
    (1.0 + 2.0 ** -10 + 2.0 ** -11, 1.0 + 2.0 ** -9),
    (2.0 - 2.0 ** -11, 2.0),                  # tie below a power of two
    (2.0 - 2.0 ** -12, 2.0),                  # carries into the exponent
    (-(2.0 - 2.0 ** -12), -2.0),
    (2.0 - 2.0 ** -10, 2.0 - 2.0 ** -10),     # a TF32 value stays
    (2.0 ** -100, 2.0 ** -100),               # powers of two stay
    (-(2.0 ** 100), -(2.0 ** 100)),
    (3.0 * 2.0 ** -60 + 2.0 ** -70, 3.0 * 2.0 ** -60 + 2.0 ** -69),
    (0.0, 0.0),
    (-0.0, -0.0),
    (float(np.finfo(np.float32).max), math.inf),   # past the largest TF32
    (math.inf, math.inf),
    (-math.inf, -math.inf),
]


@pytest.mark.parametrize("x, want", ROUNDING,
                         ids=[f"{x!r}" for x, _ in ROUNDING])
def test_tf32_rounding_is_round_to_nearest_ties_away(x, want):
    got = to_tf32(torch.from_numpy(_f32(x)))
    want_t = torch.from_numpy(_f32(want))
    assert got.view(torch.int32).item() == want_t.view(torch.int32).item(), \
        (x, got.item(), want)
    assert got.view(torch.int32).item() & 0x1FFF == 0


def test_split_carries_all_but_2_to_the_minus_21():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.uniform(-1e-30, 1e-30, 512),
        rng.uniform(-1e30, 1e30, 512)]).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) | lo.view(torch.int32))
                 & 0x1FFF == 0).all())
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -21 * x.double().abs()).all())
    # the split keeps what one TF32 value drops
    assert bool(((x.double() - hi.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


def _rel_gap(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_dkv_split_products_match_the_plain_version():
    """The four products on split operands land within SPLIT_REL of the
    float32 plain version; one-product TF32 lands at least CONTROL_FACTOR
    times farther, so the test tells the split from its absence."""
    _, args, mask = _inputs()
    want = t_ref.flash_attention_bwd_dkv_ref(*args, *mask)
    split_got = dkv_on_tensor_cores(*args, *mask, mm=mm_3xtf32)
    tf32_got = dkv_on_tensor_cores(*args, *mask, mm=mm_tf32)
    for name, s_g, t_g, w in zip(("dk", "dv"), split_got, tf32_got, want):
        split_gap, tf32_gap = _rel_gap(s_g, w), _rel_gap(t_g, w)
        assert split_gap <= SPLIT_REL, (name, split_gap)
        assert tf32_gap >= CONTROL_FACTOR * split_gap, \
            (name, split_gap, tf32_gap)
        assert tf32_gap > SPLIT_REL, (name, tf32_gap)


def test_dkv_split_products_match_jax_grad():
    """Summed over each kv head's query heads, the split products' dK and
    dV equal the gradient of JAX's reference within rtol 1e-4, atol
    1e-5."""
    arrays, args, mask = _inputs(seed=1)
    q, k, v, dout = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda k_, v_: j_ref(q, k_, v_, *mask), k, v)
    want_dk, want_dv = vjp(dout)
    dk, dv = dkv_on_tensor_cores(*args, *mask, mm=mm_3xtf32)
    b, s, h, kv, d = SHAPE[:5]
    sums = t_ref.flash_attention_bwd_sum_ref(dk, dv, kv)
    for got, want in zip(sums, (want_dk, want_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_dq_split_products_match_the_plain_version():
    """The dQ pass's three products on split operands land within
    SPLIT_REL of the float32 plain version; one-product TF32 lands at least
    CONTROL_FACTOR times farther."""
    _, args, mask = _dq_inputs(seed=2)
    want, _ = t_ref.flash_attention_bwd_dq_ref(*args, *mask)
    split_gap = _rel_gap(dq_on_tensor_cores(*args, *mask, mm=mm_3xtf32),
                         want)
    tf32_gap = _rel_gap(dq_on_tensor_cores(*args, *mask, mm=mm_tf32), want)
    assert split_gap <= SPLIT_REL, split_gap
    assert tf32_gap >= CONTROL_FACTOR * split_gap, (split_gap, tf32_gap)
    assert tf32_gap > SPLIT_REL, tf32_gap


def test_dq_split_products_match_jax_grad():
    """The split products' dQ equals the query gradient of JAX's reference
    within rtol 1e-4, atol 1e-5."""
    arrays, args, mask = _dq_inputs(seed=3)
    q, k, v, dout = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda q_: j_ref(q_, k, v, *mask), q)
    (want_dq,) = vjp(dout)
    dq = dq_on_tensor_cores(*args, *mask, mm=mm_3xtf32)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), rtol=1e-4,
                               atol=1e-5)
