"""Plain PyTorch versions of flash attention (counterpart of
``repro/kernels/flash_attention/ref.py``): masked SDPA in float32, and
the three passes of the CUDA backward.

The tests and ``chip_smoke.py`` hold the CUDA kernels
(``csrc/flash_attention.cu``) against them, and the CPU route runs
:func:`flash_attention_ref`, whose gradient is plain autograd through it.
The backward passes take what the kernels take (the forward's output and
log-sum-exp), so that each kernel is held against its own plain version.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            prefix_len: int) -> torch.Tensor:
    """Masked float32 logits (b, kv, rep, s, t) of q (b, s, h, d) against
    k (b, t, kv, d), scaled by 1/sqrt(d)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d).to(torch.float32)
    logits = torch.einsum("bskrd,btkd->bkrst", qg,
                          k.to(torch.float32)) / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = (qp >= kp) if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=q.device)
    ok = ok | (kp < prefix_len)
    if window > 0:
        ok = ok & (((qp - kp) < window) | (kp < prefix_len))
    return torch.where(ok, logits, torch.tensor(NEG_INF, device=q.device))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        prefix_len: int = 0) -> torch.Tensor:
    """q: (b, s, h, d), k/v: (b, s, kv, d) -> (b, s, h, d) in q's dtype.
    Masked logits are -1e30, not -inf; ``window`` 0 is unbounded."""
    b, s, h, d = q.shape
    p = torch.softmax(_logits(q, k, causal, window, prefix_len), dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _probs_and_dp(q, k, v, lse, dout, causal, window, prefix_len):
    """P = exp(logits - lse) and dP = dO V^T, both (b, kv, rep, s, t)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    p = torch.exp(_logits(q, k, causal, window, prefix_len)
                  - lse.reshape(b, kv, h // kv, s, 1))
    dp = torch.einsum("bskrd,btkd->bkrst", dout.reshape(b, s, kv, h // kv, d),
                      v)
    return p, dp


def flash_attention_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor,
                               causal: bool = True, window: int = 0,
                               prefix_len: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the first backward kernel: dq (b, s, h, d) and
    delta = rowsum(dout * o) (b, h, s), float32."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    delta = (dout * o).sum(-1).transpose(1, 2).contiguous()       # (b,h,s)
    p, dp = _probs_and_dp(q, k, v, lse, dout, causal, window, prefix_len)
    ds = p * (dp - delta.reshape(b, kv, h // kv, s, 1))
    dq = torch.einsum("bkrst,btkd->bskrd", ds, k) / math.sqrt(d)
    return dq.reshape(b, s, h, d), delta


def flash_attention_bwd_dkv_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lse: torch.Tensor,
                                delta: torch.Tensor, dout: torch.Tensor,
                                causal: bool = True, window: int = 0,
                                prefix_len: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the second backward kernel: dk and dv of every
    query head, (b, s, h, d) each, float32."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    p, dp = _probs_and_dp(q, k, v, lse, dout, causal, window, prefix_len)
    ds = p * (dp - delta.reshape(b, kv, h // kv, s, 1))
    dk = torch.einsum("bkrst,bskrd->btkrd", ds,
                      q.reshape(b, s, kv, h // kv, d)) / math.sqrt(d)
    dv = torch.einsum("bkrst,bskrd->btkrd", p,
                      dout.reshape(b, s, kv, h // kv, d))
    return dk.reshape(b, s, h, d), dv.reshape(b, s, h, d)


def flash_attention_bwd_sum_ref(dk_part: torch.Tensor, dv_part: torch.Tensor,
                                kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the third backward kernel: each kv head's dk and
    dv (b, s, kv, d), the sum of its query heads' partials."""
    b, s, h, d = dk_part.shape
    return (dk_part.reshape(b, s, kv, h // kv, d).sum(3),
            dv_part.reshape(b, s, kv, h // kv, d).sum(3))


def flash_attention_bwd_sum_ordered(dk_part: torch.Tensor,
                                    dv_part: torch.Tensor, kv: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The third backward kernel's own arithmetic: each kv head's dk and
    dv (b, s, kv, d) as float32 adds of its query heads' partials in head
    order, starting from 0, so that the kernel equals it bit for bit
    (``torch.sum`` may add in another order)."""
    b, s, h, d = dk_part.shape
    parts = [p.reshape(b, s, kv, h // kv, d) for p in (dk_part, dv_part)]
    sums = []
    for part in parts:
        acc = torch.zeros((b, s, kv, d), dtype=part.dtype,
                          device=part.device)
        for r in range(h // kv):
            acc = acc + part[:, :, :, r]
        sums.append(acc)
    return sums[0], sums[1]
