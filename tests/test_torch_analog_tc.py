"""The analog readout kernels' tensor-core route (``csrc/analog_readout.cu``
``analog_mma_kernel``), emulated in torch on the CPU: what each MMA and
each ADC conversion computes, against the plain versions
(``kernels/analog_readout/ref.py``) and JAX's ``analog_readout_pallas`` in
interpret mode.

* The chunk-diagonal B fragment: an m16n8k16 step spans 16 / chunk chunks;
  B column j stands for output column j // CPS and chunk j % CPS, and a
  lane (g, tig) holds W's bytes k = 4 tig .. 4 tig + 3 of column g only
  where they fall in that chunk. Built as explicit (k16 x n8) int8 tiles
  from (Pw, Kw, N) planes and multiplied in int32, every accumulator entry
  is one chunk sum, equal to ``chunk_sum_blocks``' bit for bit, with the
  activation planes unpadded (Ka < Kw, Ka not a chunk multiple).
* The full-rate ADC in float32: y = 1 / lsb, q0 = s * y and two FMA
  residual corrections, then rounding by adding 1.5 * 2^23 (the FMAs
  emulated exactly: products in float64, the sum's float64 rounding
  error recovered so that float32 rounding happens once). The quotient
  equals the IEEE divide ``s / lsb`` and the code ``torch.round(s / lsb)``
  (the plain version's) for every integer chunk sum of a w4a4 chunk, for
  every ADC width, and on random floats; the same ADC without its
  corrections misses.
* The whole chain (codes carried as 1.5 * 2^23 + code in uint32, shifted
  by 16^(d+e), the constant taken off once, then the epilogue) equals the
  plain versions and JAX's Pallas kernel bit for bit.

Everything is integer-exact or one IEEE operation at a time, so every
check is bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.analog_readout.analog_readout import (
    analog_fullscale_pallas, analog_readout_pallas)
from repro.kernels.analog_readout.ref import clamp_fullscale as jax_clamp
from repro.kernels.analog_readout.ref import inv_half_levels as jax_inv_half
from repro_torch.kernels.analog_readout import ops, ref
from repro_torch.kernels.analog_readout.analog_readout import (MMA_CHUNKS,
                                                               analog_route)

MAGIC = torch.tensor(1.5 * 2 ** 23, dtype=torch.float32)
MAGIC_BITS = 0x4B400000
FAST_LIMIT = 2.0 ** 21        # |s / lsb| below it rounds by the magic add
PLANES = ((1, 1), (1, 2), (2, 1), (2, 2))
# (M, Ka, Kw, N): ragged M and N, Ka below Kw and not a chunk multiple,
# Ka past a whole stage, Ka = Kw
SHAPES = ((37, 45, 64, 21), (20, 76, 96, 9), (16, 48, 48, 8))
# full scales an integer chunk sum can give, and random ones
FULL_SCALES = (1, 2, 3, 7, 15, 100, 225, 901, 1000)


def _planes(seed, pa, pw, m, ka, kw, n):
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, size=(pa, m, ka)).astype(np.int8)
    w = rng.integers(-15, 16, size=(pw, kw, n)).astype(np.int8)
    a_s = (rng.random((m, 1)) * 0.99 + 0.01).astype(np.float32)
    w_s = (rng.random((1, n)) * 0.99 + 0.01).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return a, w, a_s, w_s, bias


def _geometry(chunk):
    cps = 16 // chunk             # chunks per k16 step
    return cps, 8 // cps          # output columns per n8 tile


def _b_on(chunk):
    """(16, 8) bool: the lane rule of the kernel's B select. Entry (k, j)
    lives in lane g = j, tig = k // 4, which keeps W's byte where
    (4 tig) // chunk == g % CPS."""
    cps, _ = _geometry(chunk)
    k = torch.arange(16)[:, None]
    j = torch.arange(8)[None, :]
    return (4 * (k // 4)) // chunk == j % cps


def _steps(ka):
    """k16 steps the kernel runs: up to Ka, none wholly past it."""
    return -(-ka // 16)


def mma_chunk_sums(a, w, chunk):
    """One plane pair through the kernel's MMAs: a (M, Ka) and w (Kw, N)
    int8 -> (steps * CPS, M, N) int32 chunk sums, chunk c = step * CPS +
    j % CPS. A is zero past Ka, W past Kw (the kernel's zero-filled
    loads)."""
    cps, cols = _geometry(chunk)
    m, ka = a.shape
    kw, n = w.shape
    steps = _steps(ka)
    kk, tiles = 16 * steps, -(-n // cols)
    a_p = F.pad(a.to(torch.int32), (0, kk - ka))
    w_p = torch.zeros((kk, tiles * cols), dtype=torch.int32)
    w_p[:min(kw, kk), :n] = w[:kk].to(torch.int32)
    col = torch.arange(tiles)[:, None] * cols + \
        torch.arange(8)[None, :] // cps                    # (T, 8)
    b = w_p.reshape(steps, 16, -1)[:, :, col] * \
        _b_on(chunk)[None, :, None, :].to(torch.int32)    # (S, 16, T, 8)
    x = torch.bmm(a_p.reshape(m, steps, 16).permute(1, 0, 2).contiguous(),
                  b.reshape(steps, 16, tiles * 8))        # (S, M, T*8)
    x = x.reshape(steps, m, tiles, cols, cps).permute(0, 4, 1, 2, 3)
    return x.reshape(steps * cps, m, tiles * cols)[:, :, :n]


def fma32(a, b, c):
    """fmaf: a * b + c rounded once to float32 (float32 tensors, any
    broadcast). The product is exact in float64; the float64 sum's own
    rounding error is recovered exactly (TwoSum) and decides the one case
    where rounding twice could differ, a float64 sum on a float32
    midpoint."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.double()
    toward = torch.where(s > r64, torch.tensor(float("inf")),
                         torch.tensor(float("-inf"))).to(torch.float32)
    other = torch.nextafter(r, toward)
    mid = (s != r64) & ((r64 + other.double()) * 0.5 == s)
    # on a midpoint the exact value lies on err's side of it
    up = (err > 0) == (other.double() > r64)
    fix = mid & (err != 0) & up
    return torch.where(fix, other, r)


def quotient_rn(s, lsb):
    """The kernel's s / lsb: y = RN(1 / lsb), q0 = s y, two corrections."""
    y = torch.tensor(1.0, dtype=torch.float32) / lsb
    q0 = s * y
    q1 = fma32(fma32(-lsb, q0, s), y, q0)
    return fma32(fma32(-lsb, q1, s), y, q1)


def adc_codes(s, lsb, corrected=True):
    """The kernel's ADC on float32 chunk sums ``s``: codes as float32,
    rounded by the magic add (|s / lsb| < 2^21 here). ``corrected=False``
    is the control that rounds q0 = s * RN(1 / lsb) itself."""
    q = quotient_rn(s, lsb) if corrected else \
        s * (torch.tensor(1.0, dtype=torch.float32) / lsb)
    return (q + MAGIC) - MAGIC


def fast_adc(lsb, chunk):
    """The kernel's block-uniform test: lsb normal and finite, and every
    chunk sum of int8 planes (|s| <= chunk * 128 * 128) within 2^21 lsb."""
    lsb = float(lsb)
    y = np.float32(1.0) / np.float32(lsb)
    return 2.0 ** -126 <= lsb <= 3.4028234663852886e38 and \
        float(np.float32(chunk * 128 * 128) * y) < FAST_LIMIT


def _wrap32(x):
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def emulated_fullscale(a, w, chunk):
    """Pass 1 on the tensor-core route: max |s| over the MMA outputs."""
    best = torch.zeros((), dtype=torch.int32)
    for d in range(a.shape[0]):
        for e in range(w.shape[0]):
            best = torch.maximum(best, mma_chunk_sums(a[d], w[e], chunk)
                                 .abs().max())
    return best.to(torch.float32)


def emulated_readout(a, w, a_s, w_s, fs, chunk, adc_bits, bias=None):
    """Pass 2 on the tensor-core route: MMA outputs as the float bits of
    1.5 * 2^23 + s, the ADC, code bits summed shifted in uint32, the
    constant taken off once per code, then the epilogue."""
    lsb = ref.lsb_from_fullscale(fs.reshape(1), adc_bits)
    cps, _ = _geometry(chunk)
    m, n = a.shape[1], w.shape[2]
    acc = torch.zeros((m, n), dtype=torch.int64)
    magic = 0
    for d in range(a.shape[0]):
        for e in range(w.shape[0]):
            x = mma_chunk_sums(a[d], w[e], chunk) + MAGIC_BITS
            s = x.view(torch.float32) - MAGIC               # exact
            if fast_adc(lsb, chunk):   # the rounded float's own bits
                bits = (adc_codes(s, lsb) + MAGIC).view(torch.int32)
            else:                      # the divide's code, as an integer
                bits = torch.round(s / lsb).to(torch.int64) + MAGIC_BITS
            bits = bits.to(torch.int64)
            acc = (acc + (bits.sum(0) << 4 * (d + e))) % 2 ** 32
            magic += MAGIC_BITS << 4 * (d + e)
    acc = _wrap32(acc - _steps(a.shape[2]) * cps * magic)
    out = acc.to(torch.float32) * lsb * a_s * w_s
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# the fragment mapping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", MMA_CHUNKS)
def test_b_fragment_lane_rule_is_chunk_diagonal(chunk):
    """The lanes' select keeps exactly the (k, j) with k in chunk j % CPS
    of the step: each column sums one whole chunk and nothing else."""
    cps, _ = _geometry(chunk)
    k = torch.arange(16)[:, None]
    j = torch.arange(8)[None, :]
    assert torch.equal(_b_on(chunk), k // chunk == j % cps)
    assert torch.equal(_b_on(chunk).sum(0), torch.full((8,), chunk))


@pytest.mark.parametrize("chunk", MMA_CHUNKS)
def test_epilogue_lane_mapping(chunk):
    """Each lane's code sums land on the output the accumulator layout
    gives them: entry v of lane (g, tig) is row g + 8 (v // 2), column j =
    2 tig + v % 2 of the n8 tile, i.e. output column j // CPS; at CPS = 4
    lanes tig and tig ^ 1 share a column and are combined by a shuffle."""
    cps, cols = _geometry(chunk)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for v in range(4):
            row, j = g + 8 * (v >> 1), 2 * tig + (v & 1)
            slot = v if cps == 1 else v >> 1
            if cps == 1:
                k_row, k_col = g + 8 * (slot >> 1), 2 * tig + (slot & 1)
            elif cps == 2:
                k_row, k_col = g + 8 * slot, tig
            else:
                k_row, k_col = g + 8 * slot, tig >> 1
            assert (k_row, k_col) == (row, j // cps)
            assert k_col < cols


@pytest.mark.parametrize("m,ka,kw,n", SHAPES)
@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("chunk", MMA_CHUNKS)
def test_tile_products_equal_chunk_sums(chunk, pa, pw, m, ka, kw, n):
    """The chunk-diagonal tiles' int32 products are the plain version's
    chunk sums, unpadded activations against padded weights; the chunks
    the kernel never forms (wholly past Ka) are zero there."""
    a, w, *_ = [torch.from_numpy(v) for v in
                _planes(chunk + m, pa, pw, m, ka, kw, n)]
    a_pad = F.pad(a, (0, kw - ka))
    blocks = {}
    for d, e, sums in ref.chunk_sum_blocks(a_pad, w, chunk):
        blocks.setdefault((d, e), []).append(sums)
    for (d, e), parts in blocks.items():
        want = torch.cat(parts).to(torch.int32)           # (Kw/chunk, M, N)
        got = mma_chunk_sums(a[d], w[e], chunk)
        formed = min(len(want), len(got))
        assert formed >= -(-ka // chunk)
        assert torch.equal(got[:formed], want[:formed])
        assert not bool(want[formed:].any()) and not bool(got[formed:].any())


# ---------------------------------------------------------------------------
# the ADC
# ---------------------------------------------------------------------------
def _lsbs(full_scales, adc_bits):
    fs = torch.tensor(full_scales, dtype=torch.float32).reshape(-1, 1)
    inv = torch.tensor(ref.inv_half_levels(adc_bits), dtype=torch.float32)
    return ref.clamp_fullscale(fs) * inv


@pytest.mark.parametrize("chunk", MMA_CHUNKS)
def test_adc_equals_divide_on_every_integer_sum(chunk):
    """Every integer chunk sum of w4a4 digits, |s| <= chunk * 225, every
    ADC width 2-24, full scales an integer sum can give (and the floor):
    the corrected quotient is the IEEE divide's bit for bit, and where
    the kernel rounds by the magic add, the code is rint(s / lsb)."""
    top = chunk * 225
    s = torch.arange(-top, top + 1, dtype=torch.float32).reshape(1, -1)
    rng = np.random.default_rng(chunk)
    grid = FULL_SCALES + (top - 1, top, 0) + \
        tuple(int(v) for v in rng.integers(1, top, 24))
    rounded = 0
    for adc_bits in range(2, 25):
        lsb = _lsbs(grid, adc_bits)
        want = s / lsb
        assert torch.equal(quotient_rn(s, lsb), want), adc_bits
        near = want.abs() < FAST_LIMIT
        assert torch.equal(adc_codes(s, lsb)[near], torch.round(want)[near])
        rounded += int(near.sum())
    assert rounded > 0.5 * s.numel() * len(grid) * 23


@pytest.mark.parametrize("adc_bits", (3, 5, 8, 16, 24))
def test_adc_equals_divide_on_random_floats(adc_bits):
    """10^6 random floats (what noisy chunk sums are) in [-fs, fs]."""
    gen = torch.Generator().manual_seed(adc_bits)
    for fs in (7.0, 1800.0, 3600.0):
        s = (torch.rand(10 ** 6, generator=gen) * 2 - 1) * fs
        lsb = _lsbs((fs,), adc_bits).reshape(())
        want = s / lsb
        assert torch.equal(quotient_rn(s, lsb), want)
        near = want.abs() < FAST_LIMIT
        assert torch.equal(adc_codes(s, lsb)[near], torch.round(want)[near])


def test_adc_without_the_corrections_misses():
    """The control: rounding q0 = s * RN(1 / lsb) itself differs from the
    divide's code somewhere on the same grid (ties, mostly), so the
    corrections are needed."""
    s = torch.arange(-1800, 1801, dtype=torch.float32).reshape(1, -1)
    misses = 0
    for adc_bits in range(2, 25):
        lsb = _lsbs(FULL_SCALES + (1799, 1800), adc_bits)
        code = adc_codes(s, lsb, corrected=False)
        misses += int((code != torch.round(s / lsb)).sum())
    assert misses > 0


def test_fma32_rounds_once():
    """The emulated fmaf against exact rational arithmetic, on products
    whose float64 sum lands on a float32 midpoint and on random ones."""
    from fractions import Fraction
    cases = [(1.0, 1.0, 2.0 ** -24 + 2.0 ** -60),       # midpoint, err > 0
             (1.0, 1.0, 2.0 ** -24 - 2.0 ** -60),       # just below it
             (1.0, 1.0, 2.0 ** -24), (3.0, 1.0 + 2.0 ** -23, -3.0)]
    rng = np.random.default_rng(0)
    cases += [tuple(float(np.float32(v)) for v in rng.standard_normal(3))
              for _ in range(200)]
    for a, b, c in cases:
        got = float(fma32(*(torch.tensor(v, dtype=torch.float64)
                            .to(torch.float32) for v in (a, b, c))))
        exact = Fraction(float(np.float32(a))) * Fraction(
            float(np.float32(b))) + Fraction(float(np.float32(c)))
        lo = np.float32(float(exact))
        cands = {float(lo), float(np.nextafter(lo, np.float32(np.inf))),
                 float(np.nextafter(lo, np.float32(-np.inf)))}
        best = min(cands, key=lambda v: (abs(Fraction(v) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got == best, (a, b, c)


# ---------------------------------------------------------------------------
# the whole chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("chunk,adc_bits", ((4, 3), (8, 5), (16, 8),
                                            (8, 24)))
def test_emulated_chain_equals_plain(chunk, adc_bits, pa, pw):
    """Both passes on the route, with unpadded activations, against the
    plain versions on padded ones, with and without a bias (a 24-bit ADC:
    the blocks divide)."""
    assert fast_adc(ref.lsb_from_fullscale(torch.tensor([900.0]),
                                           adc_bits), chunk) == \
        (adc_bits < 24)
    m, ka, kw, n = 37, 45, 64, 21
    a, w, a_s, w_s, bias = [torch.from_numpy(v) for v in
                            _planes(7 * chunk + pa, pa, pw, m, ka, kw, n)]
    a_pad = F.pad(a, (0, kw - ka))
    fs = emulated_fullscale(a, w, chunk)
    want_fs = ref.analog_fullscale_ref(a_pad, w, chunk)
    assert torch.equal(fs, want_fs)
    for b in (None, bias):
        assert torch.equal(
            emulated_readout(a, w, a_s, w_s, fs, chunk, adc_bits, b),
            ref.analog_readout_ref(a_pad, w, a_s, w_s, want_fs, chunk,
                                   adc_bits, bias=b))


def test_emulated_chain_equals_jax_interpret_kernel():
    """JAX's two Pallas kernels in interpret mode (which take one K: the
    activations padded) against the route's emulation on unpadded ones,
    bit for bit."""
    pa, pw, m, ka, kw, n, chunk, adc_bits = 2, 2, 40, 45, 64, 24, 8, 5
    a, w, a_s, w_s, _ = _planes(11, pa, pw, m, ka, kw, n)
    a_pad = np.pad(a, ((0, 0), (0, 0), (0, kw - ka)))
    kw_args = dict(chunk=chunk, interpret=True)
    fs_j = analog_fullscale_pallas(jnp.asarray(a_pad), jnp.asarray(w),
                                   **kw_args)
    lsb_j = jax_clamp(fs_j) * jax_inv_half(adc_bits)
    out_j = analog_readout_pallas(jnp.asarray(a_pad), jnp.asarray(w),
                                  jnp.asarray(a_s), jnp.asarray(w_s), lsb_j,
                                  **kw_args)
    t = [torch.from_numpy(v) for v in (a, w, a_s, w_s)]
    fs = emulated_fullscale(t[0], t[1], chunk)
    assert float(fs) == float(fs_j)
    np.testing.assert_array_equal(
        emulated_readout(*t, fs, chunk, adc_bits).numpy(), np.asarray(out_j))


def test_route_choice_and_cpu_entry_with_unpadded_activations():
    """The route chooser, and the entry point on CPU tensors with Ka < Kw
    (it pads for the plain version) against the padded call."""
    assert [analog_route(c, False) for c in (3, 4, 8, 16, 24)] == \
        ["simt", "mma_sync", "mma_sync", "mma_sync", "simt"]
    assert analog_route(8, True) == "simt"
    a, w, a_s, w_s, bias = [torch.from_numpy(v) for v in
                            _planes(3, 2, 1, 9, 27, 32, 10)]
    kw = dict(chunk=8, adc_bits=5)
    assert torch.equal(ops.analog_matmul_fused(a, w, a_s, w_s, None, bias,
                                               **kw),
                       ops.analog_matmul_fused(F.pad(a, (0, 5)), w, a_s, w_s,
                                               None, bias, **kw))
