"""Core LM layers: norms, embeddings, RoPE, MLPs (counterpart of
``repro/models/layers.py``). Pure functions over dict params.

Parameter names keep the JAX package's suffixes (``*_dh`` column
projections, ``*_hd`` row projections, ``*_vd`` vocab tables, ``*_dn``
SSM B/C projections): ``launch.serve.plan_params_for_pim`` selects what
it programs by them, and sharded training splits leaves by them.

Sharded training. Under a training :class:`~repro_torch.distributed.
sharding.ShardingContext` a call site that names its leaf
(``proj(x, p["wi_dh"], "wi_dh")``) gets the split route when this rank
stores the leaf split: a column split computes this rank's output
columns (gathered unless the caller takes the shard, ``local=True``), a
row split contracts this rank's block of K (slicing a whole input) and
sums over the axis; ``embed`` and ``unembed`` are vocab-parallel. The
crossings carry their gradients (:mod:`repro_torch.distributed.
collectives`). Without such a context, or for a leaf stored whole, every
function here runs its single-device code.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pim import Plan
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import current_context
from repro_torch.engine import matmul as engine_matmul

Params = Dict[str, torch.Tensor]


def matmul_promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul`` does
    for mixed operands (torch raises on a bf16 x f32 product)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def split_of(t, name: Optional[str]):
    """(mesh, axis, dim) of the split this rank stores leaf ``name`` under
    (``t`` its local tensor, without a layer axis), or None: no training
    context, or the leaf is stored whole."""
    ctx = current_context()
    spec = None if ctx is None else ctx.split_of(name, t)
    if spec is None:
        return None
    dim = next(i for i, axes in enumerate(spec) if axes is not None)
    return ctx.mesh, spec[dim], dim


def split_ranks(t, name: Optional[str]) -> Tuple[int, int]:
    """(ranks the leaf is split over, this rank's block); (1, 0) when it
    is stored whole."""
    split = split_of(t, name)
    if split is None:
        return 1, 0
    mesh, axis, _ = split
    return mesh.size(axis), mesh.index(axis)


def whole(t: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """Leaf ``name`` whole: a split leaf gathered from the ranks of its
    axis (for replicated work; the gradient's own block back), anything
    else as it is."""
    split = split_of(t, name)
    if split is None:
        return t
    mesh, axis, dim = split
    return coll.gather_from(t, mesh, axis, dim)


def shared(t: torch.Tensor, like: torch.Tensor, name: Optional[str]
           ) -> torch.Tensor:
    """A replicated parameter ``t`` applied to rank-specific data: the data
    come from leaf ``name``'s column split (``like``, this rank's local
    leaf), so the parameter's gradient is summed over that split's axis.
    ``t`` itself where the leaf is stored whole."""
    split = split_of(like, name)
    if split is None:
        return t
    mesh, axis, _ = split
    return coll.copy_to(t, mesh, axis)


def proj(x: torch.Tensor, w, name: Optional[str] = None,
         local: bool = False) -> torch.Tensor:
    """Projection matmul with weight-stationary PIM dispatch: a programmed
    :class:`~repro_torch.core.pim.Plan` runs through the engine on its
    recorded substrate and comes back in ``x``'s dtype; anything else is a
    plain float matmul.

    ``name`` names the leaf ``w`` for sharded training: a column split
    returns this rank's output columns with ``local=True`` (its consumer
    takes the shard) and the gathered output otherwise; a row split takes
    either this rank's block of K (``x`` as narrow as ``w``) or the whole
    input, which it slices, and returns the sum over the axis."""
    if isinstance(w, Plan):
        return engine_matmul(x, w).to(x.dtype)
    split = split_of(w, name)
    if split is None:
        return matmul_promote(x, w)
    mesh, axis, dim = split
    if dim == w.dim() - 1:                      # column split
        y = matmul_promote(coll.copy_to(x, mesh, axis), w)
        return y if local else coll.gather_from(y, mesh, axis, -1)
    if x.shape[-1] != w.shape[0]:               # row split, whole input
        x = coll.scatter_to(x, mesh, axis, -1)
    return coll.reduce_from(matmul_promote(x, w), mesh, axis)


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
    """The MLP; under sharded training the hidden stays split between the
    column and the row projections."""
    h = proj(x, p["wi_dh"], "wi_dh", local=True)
    act = activation_fn(activation)
    if "wg_dh" in p:
        h = act(proj(x, p["wg_dh"], "wg_dh", local=True)) * h
    else:
        h = act(h)
    return proj(h, p["wo_hd"], "wo_hd")


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, device=device)
            * 0.02).to(dtype)


def embed(table_vd: torch.Tensor, tokens: torch.Tensor,
          name: Optional[str] = None) -> torch.Tensor:
    """The table's rows at ``tokens``. Vocab-parallel where this rank
    stores a block of the table's rows: each rank looks up the tokens in
    its block (zero rows elsewhere) and the blocks' rows are summed."""
    split = split_of(table_vd, name)
    if split is None:
        return table_vd[tokens]
    mesh, axis, _ = split
    local = tokens - mesh.index(axis) * table_vd.shape[0]
    mine = (local >= 0) & (local < table_vd.shape[0])
    rows = table_vd[torch.where(mine, local, torch.zeros_like(local))]
    return coll.reduce_from(rows * mine[..., None].to(rows.dtype), mesh,
                            axis)


def unembed(table_vd: torch.Tensor, x: torch.Tensor,
            name: Optional[str] = None) -> torch.Tensor:
    """Logits ``x @ table.T``; where this rank stores a block of the
    table's rows, the logits of that block of the vocab
    (:func:`vocab_shard` gives its offset)."""
    split = split_of(table_vd, name)
    if split is not None:
        mesh, axis, _ = split
        x = coll.copy_to(x, mesh, axis)
    return matmul_promote(x, table_vd.T)


def vocab_shard(table_vd: torch.Tensor, name: Optional[str]):
    """(mesh, axis, first vocab row) of this rank's block of a
    vocab-parallel table, or None when the table is stored whole."""
    split = split_of(table_vd, name)
    if split is None:
        return None
    mesh, axis, _ = split
    return mesh, axis, mesh.index(axis) * table_vd.shape[0]
