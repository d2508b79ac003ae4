"""Public wrappers for the PIM matmul kernel (counterpart of
``repro/kernels/pim_matmul/ops.py``).

``pim_matmul_fused`` is the planned-weight entry point behind the engine's
``exact-cuda`` substrate (int32 accumulation + fused dequant epilogue);
``pim_matmul_int`` is the raw integer-plane entry point;
``pim_matmul_quantized`` is the end-to-end float API (quantize -> planes
-> fused kernel -> float) for callers that hold raw codes. Model code
programs a plan with ``engine.program`` and executes with
``engine.matmul`` instead of calling these directly.

Dispatch is by device: tensors on the CPU take the plain version in
:mod:`.ref`; CUDA tensors launch the kernel (or raise — there is no
fallback). ``LAUNCHES`` counts kernel launches per entry point.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.pim_matmul.pim_matmul import (LAUNCHES,
                                                       pim_matmul_cuda,
                                                       pim_matmul_fused_cuda,
                                                       reset_launches)
from repro_torch.kernels.pim_matmul.ref import (pim_matmul_fused_ref,
                                                pim_matmul_ref)
from repro_torch.kernels.runtime import on_cuda
from repro_torch.quant.nibbles import to_nibbles
from repro_torch.quant.quantize import quantize

__all__ = ["LAUNCHES", "reset_launches", "pim_matmul_int",
           "pim_matmul_fused", "pim_matmul_quantized"]


def pim_matmul_int(a_planes: torch.Tensor, w_planes: torch.Tensor
                   ) -> torch.Tensor:
    """(Pa, M, K) x (Pw, K, N) nibble planes -> (M, N) int32."""
    if on_cuda(a_planes, w_planes):
        return pim_matmul_cuda(a_planes, w_planes)
    return pim_matmul_ref(a_planes, w_planes)


def pim_matmul_fused(a_planes: torch.Tensor, w_planes: torch.Tensor,
                     a_scale: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     want_rowsum: bool = False):
    """Nibble planes + scales -> (M, N) float32 via the fused epilogue.

    a_scale: (M, 1) per-row act scales; w_scale: (1, N) per-column weight
    scales; bias: optional (1, N). Bit-identical to
    :func:`~repro_torch.kernels.pim_matmul.ref.pim_matmul_fused_ref`, with
    or without a bias. ``want_rowsum`` also returns the (M,) int32
    accumulator row-sums (``(out, rowsum)`` pair).
    """
    if on_cuda(a_planes, w_planes, a_scale, w_scale, bias):
        return pim_matmul_fused_cuda(a_planes, w_planes, a_scale, w_scale,
                                     bias, want_rowsum=want_rowsum)
    return pim_matmul_fused_ref(a_planes, w_planes, a_scale, w_scale, bias,
                                want_rowsum=want_rowsum)


def pim_matmul_quantized(x: torch.Tensor, w_q_values: torch.Tensor,
                         w_q_scale: torch.Tensor, weight_bits: int = 4,
                         act_bits: int = 4) -> torch.Tensor:
    """Float (..., K) x quantized (K, N) -> float (..., N) via the fused
    kernel. Callers that execute repeatedly should program a plan with
    ``prepare_weights`` so the plane decomposition happens once."""
    orig = tuple(x.shape)
    n = w_q_values.shape[-1]
    x2 = x.reshape(-1, orig[-1])
    a_q = quantize(x2, bits=act_bits, axis=(1,))
    a_planes = to_nibbles(a_q.values, act_bits)
    w_planes = to_nibbles(w_q_values, weight_bits)
    w_scale = torch.broadcast_to(w_q_scale.to(torch.float32),
                                 (1, n)).contiguous()
    out = pim_matmul_fused(a_planes, w_planes, a_q.scale, w_scale)
    return out.reshape(orig[:-1] + (n,))
