"""Frozen quantization semantics of the w4a4 datapath, for the plain
references.

The configuration states them; the program implements them in its own
code, which may change. Symmetric abs-max codes with a signed range of
``2**(bits-1) - 1`` (4 bits: [-7, 7]), round half to even, an IEEE divide
by the scale (never a multiply by its reciprocal), the arithmetic in the
input's dtype and the scale kept in float32 afterwards. Weights are
quantized per output column, activations per row at every call. A
product of codes is exact; its dequantization is ``(acc * a_scale) *
w_scale`` in float32, then the bias.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize(x: torch.Tensor, bits: int, dim: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes (in ``x``'s dtype, integer valued) and the float32 scale,
    abs-max over ``dim`` (kept)."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, EPS) / qmax(bits)
    codes = torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))
    return codes, scale.to(torch.float32)


def fake_quantize(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Codes times scale, in float32."""
    codes, scale = quantize(x, bits, dim)
    return codes.to(torch.float32) * scale


class QuantWeight:
    """A (K, N) weight as float32 codes and a (1, N) float32 scale, per
    output column."""

    def __init__(self, w: torch.Tensor, bits: int):
        codes, self.scale = quantize(w.to(torch.float32), bits, dim=0)
        self.codes = codes.to(torch.float32)

    def to(self, dtype: torch.dtype) -> "QuantWeight":
        out = QuantWeight.__new__(QuantWeight)
        out.codes = self.codes.to(dtype)
        out.scale = self.scale.to(dtype)
        return out


def qmatmul(x: torch.Tensor, w: QuantWeight, act_bits: int,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) through the quantized weight: per-row activation codes
    from ``x`` in its own dtype, an exact integer product (float32 codes,
    sums far below 2**24, with TF32 off), ``(acc * a_scale) * w_scale``
    (+ bias) in float32, returned in ``out_dtype`` (default float32).

    With ``w`` in bfloat16 (:meth:`QuantWeight.to`), the product and the
    dequantization run in bfloat16: the control's lower precision."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    codes, a_scale = quantize(x2, act_bits, dim=1)
    dt = w.codes.dtype
    acc = codes.to(dt) @ w.codes
    out = (acc * a_scale.to(dt)) * w.scale
    if bias is not None:
        out = out + bias.to(dt)
    out = out.reshape(lead + (w.codes.shape[1],))
    return out if out_dtype is None else out.to(out_dtype)
