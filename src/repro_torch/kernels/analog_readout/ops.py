"""Public entry point of the analog readout kernels (counterpart of
``repro/kernels/analog_readout/ops.py``).

``analog_matmul_fused`` is the planned-weight entry point behind the
engine's ``analog-cuda`` substrate. Dispatch is by device: CUDA tensors
run the ranging pass and the readout pass back to back, with the full
scale kept on the card between them, over the activation planes as
given (no K padding); CPU tensors take the plain version in :mod:`.ref`,
with the activation planes padded to the weight planes' K. There is no
fallback. Model code programs a plan with ``engine.program``
(``substrate="analog-cuda"``) and executes it with ``engine.matmul``
instead of calling this directly.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.analog_readout.analog_readout import (
    LAUNCHES, analog_fullscale_cuda, analog_readout_cuda, reset_launches)
from repro_torch.kernels.analog_readout.ref import analog_readout_fused_ref
from repro_torch.kernels.runtime import on_cuda

__all__ = ["LAUNCHES", "reset_launches", "analog_matmul_fused"]


def analog_matmul_fused(a_planes: torch.Tensor, w_planes: torch.Tensor,
                        a_scale: torch.Tensor, w_scale: torch.Tensor,
                        seed: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None, *,
                        chunk: int, adc_bits: int, sigma: float = 0.0
                        ) -> torch.Tensor:
    """Nibble planes + scales -> (M, N) float32 through the analog readout
    chain (WDM-chunk sums, optional noise, shared auto-ranged ADC, integer
    code accumulation, shift-and-add, dequant epilogue).

    a_planes (Pa, M, Ka) int8; w_planes (Pw, Kw, N) int8 with Ka <= Kw
    (the activations are zero beyond Ka, so a plan's K padding needs no
    copy of them); a_scale (M, 1); w_scale (1, N); bias (1, N) or None.
    ``seed`` is a host int keying the counter-based noise; ``None`` or
    ``sigma == 0`` gives the deterministic ADC-only transfer, on which the
    kernels equal the plain version bit for bit."""
    kw = w_planes.shape[1]
    if on_cuda(a_planes, w_planes, a_scale, w_scale, bias):
        pad = (-kw) % chunk
        if pad:       # absolute chunk boundaries: right zero-padding is exact
            w_planes = F.pad(w_planes, (0, 0, 0, pad))
        fs = analog_fullscale_cuda(a_planes, w_planes, chunk=chunk,
                                   sigma=sigma, seed=seed)
        return analog_readout_cuda(a_planes, w_planes, a_scale, w_scale, fs,
                                   chunk=chunk, adc_bits=adc_bits,
                                   sigma=sigma, seed=seed, bias=bias)
    if a_planes.shape[2] < kw:   # the plain version takes one K
        a_planes = F.pad(a_planes, (0, kw - a_planes.shape[2]))
    return analog_readout_fused_ref(a_planes, w_planes, a_scale, w_scale,
                                    chunk, adc_bits, sigma=sigma, seed=seed,
                                    bias=bias)
