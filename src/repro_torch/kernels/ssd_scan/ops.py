"""Public entry point of the SSD scan (counterpart of
``repro/kernels/ssd_scan/ops.py``).

``backend`` names the route:

  ``"cuda"``        the hand-written kernel (JAX names ``"pallas"`` and
                    ``"pallas_interp"`` are aliases); on CPU tensors its
                    plain version, the chunked form;
  ``"chunked"``     the chunk-parallel form in plain PyTorch (default);
  ``"sequential"``  the step-by-step recurrence in plain PyTorch.

``chunk = min(chunk, L)``. On CUDA tensors ``"cuda"`` always launches the
kernel, a ragged ``L % chunk != 0`` included (the kernel masks the tail
exactly). The plain routes take a ragged L sequentially, as the JAX
package does for every backend.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.runtime import on_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (LAUNCHES, reset_launches,
                                                   ssd_scan_cuda)

__all__ = ["LAUNCHES", "reset_launches", "ssd_scan", "resolve_backend",
           "BACKENDS"]

BACKENDS = ("chunked", "sequential", "cuda")
BACKEND_ALIASES = {"pallas": "cuda", "pallas_interp": "cuda"}


def resolve_backend(backend: str) -> str:
    """A backend name (JAX aliases accepted) -> one of :data:`BACKENDS`."""
    name = BACKEND_ALIASES.get(backend, backend)
    if name not in BACKENDS:
        raise ValueError(f"unknown ssd_backend {backend!r}; expected one of "
                         f"{BACKENDS} or {tuple(BACKEND_ALIASES)}")
    return name


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128, backend: str = "chunked"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH, L, P), a (BH, L), b and c (BH, L, N) -> y (BH, L, P) and the
    final state (BH, N, P), float32."""
    backend = resolve_backend(backend)
    l = x.shape[1]
    chunk = min(chunk, l)
    if backend == "cuda" and on_cuda(x, a, b, c):
        return ssd_scan_cuda(*(t.to(torch.float32).contiguous()
                               for t in (x, a, b, c)), chunk)
    if backend == "sequential" or l % chunk:
        return ssd_scan_ref(x, a, b, c)
    return ssd_chunked_ref(x, a, b, c, chunk=chunk)
