"""Core LM layers: norms, embeddings, RoPE, MLPs (counterpart of
``repro/models/layers.py``). Pure functions over dict params.

Parameter names keep the JAX package's suffixes (``*_dh`` column
projections, ``*_hd`` row projections, ``*_vd`` vocab tables, ``*_dn``
SSM B/C projections): ``launch.serve.plan_params_for_pim`` selects what
it programs by them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.pim import Plan
from repro_torch.engine import matmul as engine_matmul

Params = Dict[str, torch.Tensor]


def matmul_promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul`` does
    for mixed operands (torch raises on a bf16 x f32 product)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def proj(x: torch.Tensor, w) -> torch.Tensor:
    """Projection matmul with weight-stationary PIM dispatch: a programmed
    :class:`~repro_torch.core.pim.Plan` runs through the engine on its
    recorded substrate and comes back in ``x``'s dtype; anything else is a
    plain float matmul."""
    if isinstance(w, Plan):
        return engine_matmul(x, w).to(x.dtype)
    return matmul_promote(x, w)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device=None,
               dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=device)
            * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The head
    dimension is split into halves (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str):
    """``jax.nn.silu`` or ``jax.nn.gelu``, whose default is the tanh
    approximation."""
    if name == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


# ---------------------------------------------------------------------------
# Gated MLP (llama/qwen/gemma-style); plain MLP for non-gated configs
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, device=None, dtype=torch.float32
             ) -> Params:
    p = {"wi_dh": dense_init(gen, d_model, d_ff, device=device, dtype=dtype)}
    if gated:
        p["wg_dh"] = dense_init(gen, d_model, d_ff, device=device,
                                dtype=dtype)
    p["wo_hd"] = dense_init(gen, d_ff, d_model, device=device, dtype=dtype)
    return p


def mlp_apply(p: Params, x: torch.Tensor, activation: str = "silu"
              ) -> torch.Tensor:
    h = proj(x, p["wi_dh"])
    act = activation_fn(activation)
    if "wg_dh" in p:
        h = act(proj(x, p["wg_dh"])) * h
    else:
        h = act(h)
    return proj(h, p["wo_hd"])


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, device=device)
            * 0.02).to(dtype)


def embed(table_vd: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table_vd[tokens]


def unembed(table_vd: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return matmul_promote(x, table_vd.T)
