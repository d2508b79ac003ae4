"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan
(counterpart of ``repro/kernels/ssd_scan/ref.py``).

Sequential recurrence, per (batch*head):

    S_t = a_t * S_{t-1} + b_t ⊗ x_t          S in R^{N x P}
    y_t = c_t @ S_t

with a_t in (0, 1] the per-step decay, x_t in R^P the Δ-scaled input and
b_t, c_t in R^N. :func:`ssd_chunked_ref` is the chunk-parallel algorithm
the CUDA kernel (``csrc/ssd_scan.cu``) implements; both are what the
tests and ``chip_smoke.py`` hold the kernel against. Everything is
float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_FLOOR = 1e-37   # log(max(a, LOG_FLOOR)): a = 0 decays to ~exp(-85)


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, L, P), a: (BH, L), b, c: (BH, L, N); s0: optional (BH, N, P)
    initial state. Returns y (BH, L, P) and the final state (BH, N, P)."""
    bh, l, p = x.shape
    n = b.shape[-1]
    x, a, b, c = (t.to(torch.float32) for t in (x, a, b, c))
    s = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device) \
        if s0 is None else s0.to(torch.float32)
    ys = []
    for t in range(l):
        s = a[:, t, None, None] * s + b[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("zn,znp->zp", c[:, t], s))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, p))
    return y, s


def ssd_chunked_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel formulation: quadratic inside each chunk of
    ``chunk`` steps, a linear recurrence of (N, P) states across chunks.
    L must be a multiple of ``chunk``."""
    bh, l, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} must be a multiple of chunk={chunk}")
    nc = l // chunk
    xc = x.to(torch.float32).reshape(bh, nc, chunk, p)
    ac = a.to(torch.float32).reshape(bh, nc, chunk)
    bc = b.to(torch.float32).reshape(bh, nc, chunk, n)
    cc = c.to(torch.float32).reshape(bh, nc, chunk, n)

    cl = torch.cumsum(torch.log(torch.clamp_min(ac, LOG_FLOOR)), dim=-1)
    seg = torch.exp(cl[..., :, None] - cl[..., None, :])      # (bh,nc,Q,Q)
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).tril()
    # select, never multiply by the mask: above the diagonal seg can be inf
    lmat = torch.where(lower, seg, torch.zeros((), device=x.device))

    scores = torch.einsum("zcin,zcjn->zcij", cc, bc) * lmat
    y_intra = torch.einsum("zcij,zcjp->zcip", scores, xc)

    decay_to_end = torch.exp(cl[..., -1:] - cl)               # (bh,nc,Q)
    chunk_states = torch.einsum("zcjn,zcjp->zcnp",
                                bc * decay_to_end[..., None], xc)
    chunk_decay = torch.exp(cl[..., -1])                      # (bh,nc)

    s = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    starts = []
    for ci in range(nc):
        starts.append(s)
        s = chunk_decay[:, ci, None, None] * s + chunk_states[:, ci]
    s_starts = torch.stack(starts, dim=1)                     # (bh,nc,n,p)

    y_inter = torch.exp(cl)[..., None] * torch.einsum("zcin,zcnp->zcip", cc,
                                                      s_starts)
    return (y_intra + y_inter).reshape(bh, l, p), s
