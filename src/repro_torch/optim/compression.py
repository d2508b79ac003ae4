"""Gradient compression with error feedback (counterpart of
``repro/optim/compression.py``).

Each gradient leaf is quantized to symmetric int8 codes with one float32
scale, and the quantization residual is kept (error feedback) and added
back the next step. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes and scales equal the JAX package's bit
for bit on the same arrays.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.quant.quantize import qmax
from repro_torch.tree import leaves, tree_map, unflatten_like

PyTree = Any


def compress_leaf(g: torch.Tensor, err: Optional[torch.Tensor],
                  bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (codes int8, scale, new error residual)."""
    g32 = g.to(torch.float32)
    if err is not None:
        g32 = g32 + err
    scale = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) / qmax(bits)
    codes = torch.clamp(torch.round(g32 / scale), -qmax(bits),
                        qmax(bits)).to(torch.int8)
    recon = codes.to(torch.float32) * scale
    return codes, scale, g32 - recon


def decompress_leaf(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compress_grads(grads: PyTree, err_state: Optional[PyTree],
                   bits: int = 8) -> Tuple[PyTree, PyTree, PyTree]:
    """Tree-wise compression. Returns (codes, scales, new error state)."""
    flat = leaves(grads)
    errs = leaves(err_state) if err_state is not None else [None] * len(flat)
    out = [compress_leaf(g, e, bits) for g, e in zip(flat, errs)]
    return tuple(unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_grads(codes: PyTree, scales: PyTree) -> PyTree:
    return tree_map(decompress_leaf, codes, scales)


def init_error_state(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
