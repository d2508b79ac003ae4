"""Launch wrappers for the hand-written Hopper analog-readout kernels
(``repro_torch/csrc/analog_readout.cu``).

Counterpart of ``repro/kernels/analog_readout/analog_readout.py``: two
passes over the nibble planes replace the two Pallas kernels.

* :func:`analog_fullscale_cuda` (replaces ``analog_fullscale_pallas``) —
  the auto-ranging pass: max |chunk sum| over every plane pair, chunk,
  row and column, written into one zeroed device word.
* :func:`analog_readout_cuda` (replaces ``analog_readout_pallas``) — the
  readout pass: it reads that word, forms ``lsb`` on the card, and runs
  chunk sums, noise, ADC codes, integer code sums, shift-and-add and the
  fused epilogue.

The full scale never leaves the card between the passes. The activation
planes may be narrower in K than the weight planes (``Ka <= Kw``: A is
zero beyond Ka, so the plans' K padding needs no copy of the
activations); both passes stop at Ka. The kernels mask ragged M, N and K
themselves; Kw must be a multiple of ``chunk`` (the public entry point in
:mod:`.ops` pads it).

Two routes of the same source, chosen by :func:`analog_route`: the
tensor-core route (``"mma_sync"``: chunk sums from int8 ``mma.sync``, an
exact ADC on full-rate FMAs) for chunks of 4, 8 and 16 without noise,
and the CUDA-core route (``"simt"``) for any other chunk or with noise.
Neither falls back to the other: a launch or build error raises. The
wrappers check device, dtype, shape and contiguity, allocate outputs,
launch on PyTorch's current stream and raise on a launch error.
``LAUNCHES`` counts successful launches per pass, ``ROUTE_LAUNCHES`` the
same by route.
:func:`yardstick_fullscale` and :func:`yardstick_readout` run the
CUDA-core kernel at any chunk through the C library's yardstick symbols,
and :func:`adc_check_cuda` holds the tensor-core route's ADC against the
IEEE divide on the card; none of them counts a launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.analog_readout.ref import (FULLSCALE_FLOOR,
                                                    inv_half_levels)

LAUNCHES: Dict[str, int] = {"analog_fullscale": 0, "analog_readout": 0}
ROUTES = ("mma_sync", "simt")
# the same launches split by the route they took
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: dict.fromkeys(ROUTES, 0) for name in LAUNCHES}
# chunks the tensor-core route takes: a k16 MMA step holds whole chunks
MMA_CHUNKS = (4, 8, 16)
_ROUTE_CODE = {"mma_sync": 0, "simt": 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_UINT = ctypes.c_uint32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = dict.fromkeys(ROUTES, 0)


def analog_route(chunk: int, noisy: bool) -> str:
    """The route both passes take: ``"mma_sync"`` (chunk sums on the int8
    tensor cores, the exact ADC on FMAs) for a deterministic call at a
    chunk of 4, 8 or 16, else ``"simt"`` (the CUDA-core kernel)."""
    return "mma_sync" if chunk in MMA_CHUNKS and not noisy else "simt"


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("analog_readout")
    if lib.analog_fullscale.argtypes is None:
        # a, w, fs_word | pa, pw, m, ka, kw, n, chunk | noise, seed, sigma
        # | route | stream (the _simt yardstick: no route)
        pass1 = [_PTR] * 3 + [_INT] * 7 + [_INT, _UINT, _FLOAT]
        lib.analog_fullscale.argtypes = pass1 + [_INT, _PTR]
        lib.analog_fullscale_simt.argtypes = pass1 + [_PTR]
        # a, w, a_scale, w_scale, bias, fs_word, out | pa, pw, m, ka, kw,
        # n, chunk | inv_half, floor | noise, seed, sigma | route | stream
        pass2 = [_PTR] * 7 + [_INT] * 7 + [_FLOAT, _FLOAT, _INT, _UINT,
                                            _FLOAT]
        lib.analog_readout.argtypes = pass2 + [_INT, _PTR]
        lib.analog_readout_simt.argtypes = pass2 + [_PTR]
        # lsb | lo, hi | counts | stream
        lib.analog_adc_check.argtypes = [_FLOAT, _INT, _INT, _PTR, _PTR]
        for fn in (lib.analog_fullscale, lib.analog_fullscale_simt,
                   lib.analog_readout, lib.analog_readout_simt,
                   lib.analog_adc_check):
            fn.restype = _INT
    return lib


def _check_planes(a_planes: torch.Tensor, w_planes: torch.Tensor,
                  chunk: int) -> Tuple[int, int, int, int, int, int]:
    """(Pa, Pw, M, Ka, Kw, N) of valid planes; raises otherwise."""
    if a_planes.device.type != "cuda" or w_planes.device != a_planes.device:
        raise ValueError("the CUDA kernel takes planes on one CUDA device, "
                         f"got {a_planes.device} and {w_planes.device}")
    for name, t in (("a_planes", a_planes), ("w_planes", w_planes)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D int8 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    pa, m, ka = a_planes.shape
    pw, kw, n = w_planes.shape
    if ka > kw:
        raise ValueError(f"contraction mismatch: the activation planes' K "
                         f"{ka} exceeds the weight planes' {kw}")
    if pa not in (1, 2) or pw not in (1, 2):
        raise ValueError(f"plane counts must be 1 or 2, got {pa}, {pw}")
    if chunk < 1 or kw % chunk:
        raise ValueError(f"K={kw} must be a positive multiple of the WDM "
                         f"chunk {chunk} (pad K first)")
    if max(m, kw, n) >= 2 ** 31:
        raise ValueError(f"dimensions must fit in int32, got {m, kw, n}")
    return pa, pw, m, ka, kw, n


def _check_vector(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _noise_args(sigma: float, seed: Optional[int]):
    """(noise on?, seed as uint32, sigma): noise needs both a positive
    sigma and a seed, as in the reference."""
    noisy = sigma > 0.0 and seed is not None
    return (1 if noisy else 0), (int(seed) & 0xFFFFFFFF if noisy else 0), \
        (float(sigma) if noisy else 0.0)


def _fullscale(symbol: str, route: Tuple[int, ...], a_planes, w_planes,
               chunk, sigma, seed) -> torch.Tensor:
    pa, pw, m, ka, kw, n = _check_planes(a_planes, w_planes, chunk)
    fs = torch.zeros((1,), dtype=torch.float32, device=a_planes.device)
    noisy, seed_u32, sigma_f = _noise_args(sigma, seed)
    lib = _library()
    with torch.cuda.device(a_planes.device):
        rc = getattr(lib, symbol)(
            a_planes.data_ptr(), w_planes.data_ptr(), fs.data_ptr(),
            pa, pw, m, ka, kw, n, chunk, noisy, seed_u32, sigma_f, *route,
            runtime.stream_of(fs))
    runtime.check(lib, rc, symbol)
    return fs


def _readout(symbol: str, route: Tuple[int, ...], a_planes, w_planes,
             a_scale, w_scale, fullscale, chunk, adc_bits, sigma, seed,
             bias) -> torch.Tensor:
    pa, pw, m, ka, kw, n = _check_planes(a_planes, w_planes, chunk)
    dev = a_planes.device
    _check_vector("a_scale", a_scale, (m, 1), dev)
    _check_vector("w_scale", w_scale, (1, n), dev)
    _check_vector("fullscale", fullscale, (1,), dev)
    if bias is not None:
        _check_vector("bias", bias, (1, n), dev)
    if not 2 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in [2, 24], got {adc_bits}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    noisy, seed_u32, sigma_f = _noise_args(sigma, seed)
    lib = _library()
    with torch.cuda.device(dev):
        rc = getattr(lib, symbol)(
            a_planes.data_ptr(), w_planes.data_ptr(), a_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            fullscale.data_ptr(), out.data_ptr(), pa, pw, m, ka, kw, n,
            chunk, inv_half_levels(adc_bits), FULLSCALE_FLOOR, noisy,
            seed_u32, sigma_f, *route, runtime.stream_of(out))
    runtime.check(lib, rc, symbol)
    return out


def analog_fullscale_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor,
                          *, chunk: int, sigma: float = 0.0,
                          seed: Optional[int] = None) -> torch.Tensor:
    """Auto-ranging pass on the card: the unclamped full scale
    max |chunk sum (+ noise)| as a (1,) float32 device tensor. a_planes
    (Pa, M, Ka) int8, w_planes (Pw, Kw, N) int8, Ka <= Kw, Kw a multiple
    of ``chunk``; ``seed`` (a host int) and ``sigma > 0`` turn noise
    on."""
    route = analog_route(chunk, _noise_args(sigma, seed)[0] == 1)
    fs = _fullscale("analog_fullscale", (_ROUTE_CODE[route],), a_planes,
                    w_planes, chunk, sigma, seed)
    LAUNCHES["analog_fullscale"] += 1
    ROUTE_LAUNCHES["analog_fullscale"][route] += 1
    return fs


def analog_readout_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor,
                        a_scale: torch.Tensor, w_scale: torch.Tensor,
                        fullscale: torch.Tensor, *, chunk: int,
                        adc_bits: int, sigma: float = 0.0,
                        seed: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Readout pass on the card, given the ranging pass's (1,) full-scale
    tensor (read on the device, never synced to the host). Planes as for
    :func:`analog_fullscale_cuda`; a_scale (M, 1), w_scale (1, N), bias
    (1, N) or None, all float32 -> (M, N) float32. ``sigma``/``seed``
    must be those of the ranging pass."""
    route = analog_route(chunk, _noise_args(sigma, seed)[0] == 1)
    out = _readout("analog_readout", (_ROUTE_CODE[route],), a_planes,
                   w_planes, a_scale, w_scale, fullscale, chunk, adc_bits,
                   sigma, seed, bias)
    LAUNCHES["analog_readout"] += 1
    ROUTE_LAUNCHES["analog_readout"][route] += 1
    return out


def yardstick_fullscale(a_planes: torch.Tensor, w_planes: torch.Tensor,
                        *, chunk: int, sigma: float = 0.0,
                        seed: Optional[int] = None) -> torch.Tensor:
    """:func:`analog_fullscale_cuda`'s function through the C library's
    yardstick symbol ``analog_fullscale_simt`` (the CUDA-core kernel the
    tensor-core route replaced), at any chunk. Counts no launch."""
    return _fullscale("analog_fullscale_simt", (), a_planes, w_planes,
                      chunk, sigma, seed)


def yardstick_readout(a_planes: torch.Tensor, w_planes: torch.Tensor,
                      a_scale: torch.Tensor, w_scale: torch.Tensor,
                      fullscale: torch.Tensor, *, chunk: int,
                      adc_bits: int, sigma: float = 0.0,
                      seed: Optional[int] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`analog_readout_cuda`'s function through the yardstick symbol
    ``analog_readout_simt``. Counts no launch."""
    return _readout("analog_readout_simt", (), a_planes, w_planes, a_scale,
                    w_scale, fullscale, chunk, adc_bits, sigma, seed, bias)


def adc_check_cuda(lsb: float, lo: int, hi: int,
                   device="cuda") -> Tuple[int, int]:
    """The tensor-core route's ADC on the card for every integer chunk sum
    s in [lo, hi] (within [-2^22, 2^22]) at one float32 ``lsb`` (normal,
    finite): ``(mismatches, rounded)``, the chunk sums whose FMA quotient
    differs from ``__fdiv_rn(s, lsb)`` or whose code differs from
    ``__float2int_rn`` of it where |s / lsb| < 2^21, and how many lie in
    that range (the codes the route rounds by the magic add). Syncs;
    counts no launch."""
    counts = torch.zeros((2,), dtype=torch.int64, device=device)
    lib = _library()
    with torch.cuda.device(counts.device):
        rc = lib.analog_adc_check(float(lsb), int(lo), int(hi),
                                  counts.data_ptr(),
                                  runtime.stream_of(counts))
    runtime.check(lib, rc, "analog_adc_check")
    bad, exact = counts.tolist()
    return bad, exact
