"""Plain PyTorch versions of the PIM bit-sliced matmul kernel.

Given nibble planes ``a_planes`` (Pa, M, K) int8 and ``w_planes``
(Pw, K, N) int8 (signed digits, LSB-first base 16), the kernel computes

    out[m, n] = sum_d sum_e 16^(d+e) * sum_k a_planes[d,m,k] * w_planes[e,k,n]

in int32 with wraparound. CUDA has no int32 ``matmul``, so each plane-pair
product runs in float64, which is exact because every partial sum is an
integer far below 2^53 (|partial| <= 127 * 128 * K). The products are then
shift-added in int64 and wrapped to int32 explicitly (mod 2^32). One code
path serves the CPU and the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.nibbles import NIBBLE_BASE


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wraparound of an int64 tensor into int32."""
    low = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def plane_partials(a_planes: torch.Tensor, w_planes: torch.Tensor
                   ) -> torch.Tensor:
    """All (act-plane, weight-plane) integer products, exact, as int64:
    (Pa, M, K) x (Pw, K, N) -> (Pa, Pw, M, N)."""
    a64 = a_planes.to(torch.float64)
    w64 = w_planes.to(torch.float64)
    return torch.stack([torch.stack([(a64[d] @ w64[e]).to(torch.int64)
                                     for e in range(w64.shape[0])])
                        for d in range(a64.shape[0])])


def shift_add(partials: torch.Tensor) -> torch.Tensor:
    """Aggregation-unit recombination sum_{d,e} partial[d,e] * 16^(d+e),
    exact in int64, then wrapped to int32 like the reference's int32
    accumulator."""
    pa, pw = partials.shape[0], partials.shape[1]
    acc = torch.zeros(partials.shape[2:], dtype=torch.int64,
                      device=partials.device)
    for d in range(pa):
        for e in range(pw):
            acc = acc + partials[d, e].to(torch.int64) * NIBBLE_BASE ** (d + e)
    return wrap_int32(acc)


def pim_matmul_ref(a_planes: torch.Tensor, w_planes: torch.Tensor
                   ) -> torch.Tensor:
    """(Pa, M, K) x (Pw, K, N) int8 planes -> (M, N) int32."""
    return shift_add(plane_partials(a_planes, w_planes))


def rowsum_int32(acc: torch.Tensor) -> torch.Tensor:
    """Row-sums of an int32 accumulator with int32 wraparound (torch
    promotes integer sums to int64, so wrap explicitly)."""
    return wrap_int32(acc.to(torch.int64).sum(dim=1))


def pim_matmul_fused_ref(a_planes: torch.Tensor, w_planes: torch.Tensor,
                         a_scale: torch.Tensor, w_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         want_rowsum: bool = False):
    """The fused dequant epilogue: int32 shift-and-add, then
    ``(acc * a_scale) * w_scale (+ bias)`` in float32, one rounding per
    operation — the order the kernel's epilogue uses. a_scale: (M, 1);
    w_scale: (1, N); bias: (1, N). ``want_rowsum`` also returns the (M,)
    int32 accumulator row-sums."""
    acc = pim_matmul_ref(a_planes, w_planes)
    out = acc.to(torch.float32) * a_scale * w_scale
    if bias is not None:
        out = out + bias
    if want_rowsum:
        return out, rowsum_int32(acc)
    return out
