"""Mamba2 (SSD) block (counterpart of ``repro/models/ssm.py``).

Per-component projections -> short causal conv on (x, B, C) -> SSD scan
(:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`: the hand-written
kernel on ``backend="cuda"``) -> gated output via z -> out projection.
Decode keeps an (heads, N, P) state and a conv tail per layer, O(1) per
token.

The projections here are plain float matmuls, as in the JAX package:
serving fake-quantizes the SSM weights rather than planning them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import Params, dense_init, rms_norm

CONV_K = 4


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), exact for every x (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_dims(d_model: int, ssm_state: int, expand: int = 2,
             head_dim: int = 64, ngroups: int = 1):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * ngroups * ssm_state
    return d_inner, nheads, conv_dim


def ssm_init(gen: torch.Generator, d_model: int, ssm_state: int,
             expand: int = 2, head_dim: int = 64, ngroups: int = 1,
             device=None, dtype=torch.float32) -> Params:
    d_inner, nheads, _ = ssm_dims(d_model, ssm_state, expand, head_dim,
                                  ngroups)
    gn = ngroups * ssm_state

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, device=device, dtype=dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    log_dt = torch.empty((nheads,), device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    return {
        "wz_dh": dense(d_model, d_inner),
        "wx_dh": dense(d_model, d_inner),
        "wb_dn": dense(d_model, gn),
        "wc_dn": dense(d_model, gn),
        "wdt_dh": dense(d_model, nheads),
        "wout_hd": dense(d_inner, d_model),
        # depthwise causal convs per component
        "convx_w": normal((CONV_K, d_inner), 1.0 / math.sqrt(CONV_K)),
        "convx_b": zeros(d_inner),
        "convbc_w": normal((CONV_K, 2 * gn), 1.0 / math.sqrt(CONV_K)),
        "convbc_b": zeros(2 * gn),
        # per-head A (log), dt bias (inverse softplus of dt), D skip
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)).to(dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))).to(dtype),
        "d_skip": torch.ones((nheads,), dtype=dtype, device=device),
        "norm_d": zeros(d_inner),
    }


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel CONV_K. xc: (B, L, C); tail:
    (B, CONV_K-1, C) history for decode. Returns (out, new tail)."""
    bsz, l, c = xc.shape
    if tail is None:
        tail = torch.zeros((bsz, CONV_K - 1, c), dtype=xc.dtype,
                           device=xc.device)
    full = torch.cat([tail.to(xc.dtype), xc], dim=1)
    out = torch.zeros_like(xc)
    for i in range(CONV_K):
        out = out + full[:, i:i + l, :] * w[i]
    new_tail = full[:, -(CONV_K - 1):, :]
    return F.silu(out + b), new_tail


def _project(p: Params, x_in: torch.Tensor):
    z = x_in @ p["wz_dh"]
    x = x_in @ p["wx_dh"]
    bc = torch.cat([x_in @ p["wb_dn"], x_in @ p["wc_dn"]], dim=-1)
    dt = x_in @ p["wdt_dh"]
    return z, x, bc, dt


def ssm_apply(p: Params, x_in: torch.Tensor, ssm_state: int,
              expand: int = 2, head_dim: int = 64, ngroups: int = 1,
              backend: str = "chunked", chunk: int = 128,
              return_state: bool = False):
    """Training/prefill forward. x_in: (B, L, D) -> (B, L, D)
    [, (final ssm state (B, H, N, P), conv tails (B, CONV_K-1, conv))]."""
    bsz, l, d_model = x_in.shape
    d_inner, nheads, _ = ssm_dims(d_model, ssm_state, expand, head_dim,
                                  ngroups)
    z, x, bc, dt = _project(p, x_in)
    x, tail_x = _causal_conv(x, p["convx_w"], p["convx_b"])
    bc, tail_bc = _causal_conv(bc, p["convbc_w"], p["convbc_b"])
    bmat, cmat = torch.chunk(bc, 2, dim=-1)

    f32 = torch.float32
    dt = softplus(dt.to(f32) + p["dt_bias"])                     # (B,L,H)
    a = torch.exp(-dt * torch.exp(p["a_log"].to(f32)))            # decay
    xh = x.reshape(bsz, l, nheads, head_dim).to(f32)
    xh_dt = xh * dt[..., None]
    heads_per_group = nheads // ngroups
    bg = bmat.reshape(bsz, l, ngroups, ssm_state).to(f32)
    cg = cmat.reshape(bsz, l, ngroups, ssm_state).to(f32)
    bh = torch.repeat_interleave(bg, heads_per_group, dim=2)
    ch = torch.repeat_interleave(cg, heads_per_group, dim=2)

    def fold(t):  # (B, L, H, ...) -> (B*H, L, ...)
        t = t.movedim(2, 1)
        return t.reshape((bsz * nheads, l) + tuple(t.shape[3:]))

    y, s_fin = ssd_scan(fold(xh_dt), fold(a[..., None])[..., 0], fold(bh),
                        fold(ch), chunk=chunk, backend=backend)
    y = y.reshape(bsz, nheads, l, head_dim).movedim(1, 2)        # (B,L,H,P)
    y = y + xh * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, l, d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["norm_d"])
    y = y @ p["wout_hd"]
    if return_state:
        s_fin = s_fin.reshape(bsz, nheads, ssm_state, head_dim)
        return y, (s_fin, torch.cat([tail_x, tail_bc], dim=-1))
    return y


def ssm_init_cache(batch: int, d_model: int, ssm_state: int,
                   expand: int = 2, head_dim: int = 64, ngroups: int = 1,
                   dtype=torch.float32, device=None
                   ) -> Dict[str, torch.Tensor]:
    d_inner, nheads, conv_dim = ssm_dims(d_model, ssm_state, expand,
                                         head_dim, ngroups)
    return {
        "state": torch.zeros((batch, nheads, ssm_state, head_dim),
                             dtype=dtype, device=device),
        "conv_tail": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype,
                                 device=device),
    }


def ssm_step(p: Params, x_in: torch.Tensor, cache: Dict[str, torch.Tensor],
             ssm_state: int, expand: int = 2, head_dim: int = 64,
             ngroups: int = 1
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x_in: (B, 1, D). Returns (y, new cache)."""
    bsz, _, d_model = x_in.shape
    d_inner, nheads, _ = ssm_dims(d_model, ssm_state, expand, head_dim,
                                  ngroups)
    z, x, bc, dt = _project(p, x_in)
    tail = cache["conv_tail"]
    tail_x, tail_bc = tail[..., :d_inner], tail[..., d_inner:]
    x, new_tail_x = _causal_conv(x, p["convx_w"], p["convx_b"], tail=tail_x)
    bc, new_tail_bc = _causal_conv(bc, p["convbc_w"], p["convbc_b"],
                                   tail=tail_bc)
    bmat, cmat = torch.chunk(bc, 2, dim=-1)

    f32 = torch.float32
    dt = softplus(dt[:, 0].to(f32) + p["dt_bias"])               # (B,H)
    a = torch.exp(-dt * torch.exp(p["a_log"].to(f32)))
    xh = x[:, 0].reshape(bsz, nheads, head_dim).to(f32)
    heads_per_group = nheads // ngroups
    bh = torch.repeat_interleave(bmat[:, 0].reshape(bsz, ngroups, ssm_state),
                                 heads_per_group, dim=1).to(f32)
    ch = torch.repeat_interleave(cmat[:, 0].reshape(bsz, ngroups, ssm_state),
                                 heads_per_group, dim=1).to(f32)

    state = cache["state"].to(f32)
    state = (a[..., None, None] * state +
             bh[..., :, None] * (xh * dt[..., None])[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", ch, state)
    y = y + xh * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["norm_d"])
    new_tail = torch.cat([new_tail_x, new_tail_bc], dim=-1)
    return y @ p["wout_hd"], {
        "state": state.to(cache["state"].dtype),
        "conv_tail": new_tail.to(cache["conv_tail"].dtype)}
