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

The full scale never leaves the card between the passes. The kernels mask
ragged M, N and K themselves; K must be a multiple of ``chunk`` (the
public entry point in :mod:`.ops` pads it). The wrappers check device,
dtype, shape and contiguity, allocate outputs, launch on PyTorch's
current stream and raise on a launch error. ``LAUNCHES`` counts
successful launches per pass.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.analog_readout.ref import (FULLSCALE_FLOOR,
                                                    inv_half_levels)

LAUNCHES: Dict[str, int] = {"analog_fullscale": 0, "analog_readout": 0}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_UINT = ctypes.c_uint32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("analog_readout")
    if lib.analog_fullscale.argtypes is None:
        # a, w, fs_word | pa, pw, m, k, n, chunk | noise, seed, sigma | stream
        lib.analog_fullscale.argtypes = [_PTR] * 3 + [_INT] * 6 + \
            [_INT, _UINT, _FLOAT, _PTR]
        lib.analog_fullscale.restype = _INT
        # a, w, a_scale, w_scale, bias, fs_word, out | pa, pw, m, k, n,
        # chunk | inv_half, floor | noise, seed, sigma | stream
        lib.analog_readout.argtypes = [_PTR] * 7 + [_INT] * 6 + \
            [_FLOAT, _FLOAT, _INT, _UINT, _FLOAT, _PTR]
        lib.analog_readout.restype = _INT
    return lib


def _check_planes(a_planes: torch.Tensor, w_planes: torch.Tensor,
                  chunk: int) -> Tuple[int, int, int, int, int]:
    if a_planes.device.type != "cuda" or w_planes.device != a_planes.device:
        raise ValueError("the CUDA kernel takes planes on one CUDA device, "
                         f"got {a_planes.device} and {w_planes.device}")
    for name, t in (("a_planes", a_planes), ("w_planes", w_planes)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D int8 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    pa, m, k = a_planes.shape
    pw, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if pa not in (1, 2) or pw not in (1, 2):
        raise ValueError(f"plane counts must be 1 or 2, got {pa}, {pw}")
    if chunk < 1 or k % chunk:
        raise ValueError(f"K={k} must be a positive multiple of the WDM "
                         f"chunk {chunk} (pad K first)")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"dimensions must fit in int32, got {m, k, n}")
    return pa, pw, m, k, n


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


def analog_fullscale_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor,
                          *, chunk: int, sigma: float = 0.0,
                          seed: Optional[int] = None) -> torch.Tensor:
    """Auto-ranging pass on the card: the unclamped full scale
    max |chunk sum (+ noise)| as a (1,) float32 device tensor. a_planes
    (Pa, M, K) int8, w_planes (Pw, K, N) int8, K a multiple of
    ``chunk``; ``seed`` (a host int) and ``sigma > 0`` turn noise on."""
    pa, pw, m, k, n = _check_planes(a_planes, w_planes, chunk)
    fs = torch.zeros((1,), dtype=torch.float32, device=a_planes.device)
    noisy, seed_u32, sigma_f = _noise_args(sigma, seed)
    lib = _library()
    with torch.cuda.device(a_planes.device):
        rc = lib.analog_fullscale(
            a_planes.data_ptr(), w_planes.data_ptr(), fs.data_ptr(),
            pa, pw, m, k, n, chunk, noisy, seed_u32, sigma_f,
            runtime.stream_of(fs))
    runtime.check(lib, rc, "analog_fullscale")
    LAUNCHES["analog_fullscale"] += 1
    return fs


def analog_readout_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor,
                        a_scale: torch.Tensor, w_scale: torch.Tensor,
                        fullscale: torch.Tensor, *, chunk: int,
                        adc_bits: int, sigma: float = 0.0,
                        seed: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Readout pass on the card, given the ranging pass's (1,) full-scale
    tensor (read on the device, never synced to the host). a_scale
    (M, 1), w_scale (1, N), bias (1, N) or None, all float32 -> (M, N)
    float32. ``sigma``/``seed`` must be those of the ranging pass."""
    pa, pw, m, k, n = _check_planes(a_planes, w_planes, chunk)
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
        rc = lib.analog_readout(
            a_planes.data_ptr(), w_planes.data_ptr(), a_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            fullscale.data_ptr(), out.data_ptr(), pa, pw, m, k, n, chunk,
            inv_half_levels(adc_bits), FULLSCALE_FLOOR, noisy, seed_u32,
            sigma_f, runtime.stream_of(out))
    runtime.check(lib, rc, "analog_readout")
    LAUNCHES["analog_readout"] += 1
    return out
