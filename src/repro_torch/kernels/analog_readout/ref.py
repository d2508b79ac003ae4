"""Plain PyTorch versions of the OPIMA analog readout chain (counterpart of
``repro/kernels/analog_readout/ref.py``, paper §IV.C.4).

For nibble planes ``a_planes`` (Pa, M, K) int8 and ``w_planes``
(Pw, K, N) int8 the chain is:

  1. chunk sums — products accumulate optically inside one WDM chunk of
     the K axis: ``s[c] = sum_q a[c*chunk + q] * w[c*chunk + q]`` per
     (act-plane, weight-plane) pair; exact small integers in float32.
  2. read noise — optional: ``s + (sigma * sqrt(sum_q a^2 w^2)) * z`` with
     ``z`` a standard normal (:func:`chunk_normals`).
  3. ADC — an ``adc_bits`` converter shared by every plane pair, ranged
     once per array: ``full_scale = max |s|`` over pairs, chunks, rows
     and columns; ``lsb = max(full_scale, 1e-6) * (1 / half_levels)``
     (an explicit multiply, as in the reference); codes
     ``round_half_even(s / lsb)`` with an IEEE divide.
  4. digital accumulation — integer code sums over chunks, shift-added
     over plane pairs (``sum_{d,e} 16^(d+e) code_sum[d, e]``), int32.
  5. epilogue — ``((f32(acc) * lsb) * a_scale) * w_scale (+ bias)``.

Chunk boundaries are absolute (multiples of ``chunk`` from K index 0), so
zero-padding K on the right never changes the result.

Unlike the reference oracle, which materializes the whole
(Pa, Pw, KC, M, N) chunk-sum tensor, these versions fold over blocks of
chunks (:data:`BLOCK_ELEMS` chunk sums at a time). That is bit-identical:
max and integer code sums are exact and associative.

Noise cannot reproduce ``jax.random``'s bits. It comes from one
counter-based generator, a murmur3-style hash of ``(seed, plane pair,
absolute chunk, absolute row, absolute column)`` turned into a normal by
Box-Muller (:func:`chunk_normals`). The key does not depend on tiling, so
both passes of the CUDA kernel and this plain version draw the same
normal for the same chunk sum; the kernel evaluates the same function
(``csrc/analog_readout.cu``).
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.pim_matmul.ref import wrap_int32
from repro_torch.quant.nibbles import NIBBLE_BASE

# chunk sums held at once by the folded plain version (128 MiB of f32)
BLOCK_ELEMS = 1 << 25
FULLSCALE_FLOOR = 1e-6

_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def half_levels(adc_bits: int) -> float:
    """Positive code range of a signed ``adc_bits`` converter."""
    return float(2 ** (adc_bits - 1) - 1)


def inv_half_levels(adc_bits: int) -> float:
    """``1 / half_levels``; the lsb is ``full_scale * inv_half_levels``,
    an explicit multiply, never a divide."""
    return 1.0 / half_levels(adc_bits)


def clamp_fullscale(fs: torch.Tensor) -> torch.Tensor:
    """The full-scale floor (an all-zero drive must not divide by 0)."""
    return torch.clamp_min(fs, FULLSCALE_FLOOR)


def lsb_from_fullscale(fs: torch.Tensor, adc_bits: int) -> torch.Tensor:
    """The shared ADC step as a (1,) float32 tensor on ``fs``'s device.
    It stays a tensor: no host sync between the two passes."""
    inv = torch.tensor([inv_half_levels(adc_bits)], dtype=torch.float32,
                       device=fs.device)
    return clamp_fullscale(fs.to(torch.float32).reshape(1)) * inv


# ---------------------------------------------------------------------------
# counter-based normals (the kernel's generator, written with int64 tensors
# holding uint32 values; every product is split so nothing overflows)
# ---------------------------------------------------------------------------
def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for uint32 values ``x`` and a constant ``c``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix32(h, k):
    """One murmur3 block step: absorb the word ``k`` into the state ``h``."""
    k = _mul32(_rotl32(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)
    h = _rotl32(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _fmix32(h):
    """murmur3's finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def chunk_normals(seed: int, pair: int, c0: int, cb: int, m: int, n: int,
                  device) -> torch.Tensor:
    """Standard normals for chunks ``c0 .. c0+cb`` of plane pair ``pair``
    (``d * Pw + e``), rows ``0..m`` and columns ``0..n``: (cb, m, n)
    float32. Element (c, r, k) is a function of ``(seed, pair, c0 + c, r,
    k)`` alone:

        h  = mix(mix(mix(mix(seed, pair), chunk), row), col)
        u1 = ((fmix(mix(h, 1)) >> 8) + 1) * 2^-24      in (0, 1]
        u2 =  (fmix(mix(h, 2)) >> 8)      * 2^-24      in [0, 1)
        z  = sqrt(-2 log u1) * cos(f32(2 pi) * u2)

    each float operation rounded once in float32, as the kernel does."""
    i64 = dict(dtype=torch.int64, device=device)
    h = _mix32(seed & _M32, pair)                          # host int
    h = _mix32(h, torch.arange(c0, c0 + cb, **i64).reshape(cb, 1, 1))
    h = _mix32(h, torch.arange(m, **i64).reshape(1, m, 1))
    h = _mix32(h, torch.arange(n, **i64).reshape(1, 1, n))
    step = torch.tensor(2.0 ** -24, dtype=torch.float32, device=device)
    u1 = ((_fmix32(_mix32(h, 1)) >> 8) + 1).to(torch.float32) * step
    u2 = (_fmix32(_mix32(h, 2)) >> 8).to(torch.float32) * step
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=device)
    r = torch.sqrt(torch.log(u1) * -2.0)
    return r * torch.cos(u2 * two_pi)


# ---------------------------------------------------------------------------
# chunk sums, folded over blocks of chunks
# ---------------------------------------------------------------------------
def _pad_k(a_planes: torch.Tensor, w_planes: torch.Tensor, chunk: int):
    pad = (-a_planes.shape[2]) % chunk
    if pad:
        a_planes = F.pad(a_planes, (0, pad))
        w_planes = F.pad(w_planes, (0, 0, 0, pad))
    return a_planes, w_planes


def chunk_sum_blocks(a_planes: torch.Tensor, w_planes: torch.Tensor,
                     chunk: int, sigma: float = 0.0,
                     seed: Optional[int] = None
                     ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """Yield ``(d, e, sums)``: the (noisy) chunk sums of plane pair (d, e)
    for one block of consecutive chunks, (cb, M, N) float32, every block
    of every pair once. Noise applies when ``sigma > 0`` and ``seed`` is
    given."""
    pa, m, k = a_planes.shape
    pw, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    a_planes, w_planes = _pad_k(a_planes, w_planes, chunk)
    kc = a_planes.shape[2] // chunk
    cb = max(1, min(kc, BLOCK_ELEMS // max(1, m * n)))
    noisy = sigma > 0.0 and seed is not None
    sigma_t = torch.tensor(sigma, dtype=torch.float32,
                           device=a_planes.device)
    for d in range(pa):
        for e in range(pw):
            for c0 in range(0, kc, cb):
                nb = min(cb, kc - c0)
                ks = slice(c0 * chunk, (c0 + nb) * chunk)
                a_c = a_planes[d, :, ks].to(torch.float32).reshape(
                    m, nb, chunk).permute(1, 0, 2)         # (nb, M, chunk)
                w_c = w_planes[e, ks, :].to(torch.float32).reshape(
                    nb, chunk, n)                          # (nb, chunk, N)
                sums = torch.bmm(a_c, w_c)                 # exact integers
                if noisy:
                    psq = torch.bmm(a_c * a_c, w_c * w_c)
                    z = chunk_normals(seed, d * pw + e, c0, nb, m, n,
                                      a_planes.device)
                    sums = sums + (sigma_t * torch.sqrt(psq)) * z
                yield d, e, sums


def analog_fullscale_ref(a_planes: torch.Tensor, w_planes: torch.Tensor,
                         chunk: int, sigma: float = 0.0,
                         seed: Optional[int] = None) -> torch.Tensor:
    """The shared ADC full scale: max |chunk sum| over plane pairs, chunks,
    rows and columns, as a float32 scalar tensor (unclamped)."""
    fs = torch.zeros((), dtype=torch.float32, device=a_planes.device)
    for _, _, sums in chunk_sum_blocks(a_planes, w_planes, chunk, sigma,
                                       seed):
        fs = torch.maximum(fs, sums.abs().amax())
    return fs


def analog_readout_ref(a_planes: torch.Tensor, w_planes: torch.Tensor,
                       a_scale: torch.Tensor, w_scale: torch.Tensor,
                       fullscale: torch.Tensor, chunk: int, adc_bits: int,
                       sigma: float = 0.0, seed: Optional[int] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The readout pass given the full scale of the ranging pass: ADC
    codes, integer code sums, shift-and-add, and the epilogue. a_scale
    (M, 1), w_scale (1, N), bias (1, N) or None -> (M, N) float32."""
    lsb = lsb_from_fullscale(fullscale, adc_bits)
    m, n = a_planes.shape[1], w_planes.shape[2]
    acc = torch.zeros((m, n), dtype=torch.int64, device=a_planes.device)
    for d, e, sums in chunk_sum_blocks(a_planes, w_planes, chunk, sigma,
                                       seed):
        codes = torch.round(sums / lsb).to(torch.int64)    # converter codes
        acc += codes.sum(dim=0) * NIBBLE_BASE ** (d + e)
    out = wrap_int32(acc).to(torch.float32) * lsb * a_scale * w_scale
    if bias is not None:
        out = out + bias
    return out


def analog_readout_fused_ref(a_planes: torch.Tensor, w_planes: torch.Tensor,
                             a_scale: torch.Tensor, w_scale: torch.Tensor,
                             chunk: int, adc_bits: int, sigma: float = 0.0,
                             seed: Optional[int] = None,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The whole chain: ranging pass, then readout pass (M, N) float32."""
    fs = analog_fullscale_ref(a_planes, w_planes, chunk, sigma, seed)
    return analog_readout_ref(a_planes, w_planes, a_scale, w_scale, fs,
                              chunk, adc_bits, sigma, seed, bias)
