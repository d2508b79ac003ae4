"""Symmetric integer quantization (counterpart of
``repro/quant/quantize.py``).

Per-channel / per-tensor symmetric codes place parameters into OPCM
multi-level cells and activations onto laser amplitudes. ``bits`` counts
signed bits with a symmetric range (int8 -> [-127, 127], int4 -> [-7, 7])
so negation is exact. ``axis`` names the reduced axes of the abs-max
scale (``None`` -> per tensor).

Bit-exact with the JAX reference: ``torch.round`` rounds half to even like
``jnp.round``, and ``x / scale`` stays an IEEE divide (never a multiply by
a reciprocal).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


def qmax(bits: int) -> int:
    """Largest representable magnitude for a signed symmetric ``bits``
    code."""
    return (1 << (bits - 1)) - 1


@dataclasses.dataclass
class QTensor:
    """Integer codes + float scale. ``values`` are int8 for widths up to 8
    bits (nibble decomposition is a separate step, see
    :mod:`repro_torch.quant.nibbles`)."""

    values: torch.Tensor         # int8 codes in [-qmax, qmax]
    scale: torch.Tensor          # f32, broadcastable to values.shape
    bits: int = 8                # logical bit width of the codes

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale

    def to(self, device) -> "QTensor":
        return QTensor(values=self.values.to(device),
                       scale=self.scale.to(device), bits=self.bits)


def compute_scale(x: torch.Tensor, bits: int,
                  axis: Optional[Sequence[int]] = None,
                  eps: float = 1e-8) -> torch.Tensor:
    """abs-max symmetric scale. ``axis=None`` -> per tensor."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=tuple(axis), keepdim=True)
    return torch.clamp_min(amax, eps) / qmax(bits)


def quantize(x: torch.Tensor, bits: int = 8,
             axis: Optional[Sequence[int]] = None,
             scale: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric round-to-nearest-even quantization."""
    if scale is None:
        scale = compute_scale(x, bits, axis)
    q = torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))
    dtype = torch.int8 if bits <= 8 else torch.int32
    return QTensor(values=q.to(dtype), scale=scale.to(torch.float32),
                   bits=bits)


class _FakeQuantize(torch.autograd.Function):
    """Quantize-dequantize forward; straight-through gradient on the
    representable range, zero outside it."""

    @staticmethod
    def forward(ctx, x, bits, axis):
        scale = compute_scale(x, bits, axis)
        limit = scale * qmax(bits)
        qdq = quantize(x, bits, axis, scale=scale).dequantize()
        inside = (x.abs() <= limit).to(x.dtype)
        ctx.save_for_backward(inside)
        # the reference's expression x*inside + stop_grad(qdq - x*inside),
        # kept term for term so the forward rounds identically
        masked = x * inside
        return masked + (qdq - masked)

    @staticmethod
    def backward(ctx, grad):
        (inside,) = ctx.saved_tensors
        return grad * inside, None, None


def fake_quantize(x: torch.Tensor, bits: int = 8,
                  axis: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator gradient
    (identity on the clipped region, zero outside) — the QAT primitive."""
    return _FakeQuantize.apply(x, bits,
                               None if axis is None else tuple(axis))


def dynamic_quantize_activations(x: torch.Tensor, bits: int = 8) -> QTensor:
    """Per-row (token) dynamic activation quantization over the last
    axis: what the MDL array re-tunes per driven vector in OPIMA."""
    return quantize(x, bits=bits, axis=(x.dim() - 1,))


def quantization_mse(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Mean-squared quantization error."""
    return torch.mean((fake_quantize(x, bits) - x) ** 2)
