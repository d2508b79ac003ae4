"""Public entry point of flash attention (counterpart of
``repro/kernels/flash_attention/ops.py``).

``backend`` names the route:

  ``"cuda"``  the hand-written kernel, forward and backward (the JAX
              names ``"pallas"`` and ``"pallas_interp"`` are aliases); on
              CPU tensors its plain version;
  ``"jnp"``   the plain version (the JAX package's name for its
              reference route).

The Pallas kernel's ``bq``/``bk`` block sizes have no counterpart: the
Hopper kernel picks its own tiles and takes any sequence length.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    LAUNCHES, flash_attention_cuda, reset_launches)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.runtime import on_cuda

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "resolve_backend", "BACKENDS"]

BACKENDS = ("cuda", "jnp")
BACKEND_ALIASES = {"pallas": "cuda", "pallas_interp": "cuda"}


def resolve_backend(backend: str) -> str:
    """A backend name (JAX aliases accepted) -> one of :data:`BACKENDS`."""
    name = BACKEND_ALIASES.get(backend, backend)
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {BACKENDS} or {tuple(BACKEND_ALIASES)}")
    return name


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0, backend: str = "cuda"
                    ) -> torch.Tensor:
    """q (b, s, h, d), k and v (b, s, kv, d) -> (b, s, h, d) in q's
    dtype."""
    if resolve_backend(backend) == "cuda" and on_cuda(q, k, v):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window,
                                    prefix_len)
    return flash_attention_ref(q, k, v, causal, window, prefix_len)
