"""Mixture-of-Experts FFN: top-k router + dropless expert FFNs
(counterpart of ``repro/models/moe.py``).

Three execution paths, chosen by the params and the sharding context, as
in the JAX package:

* ``local`` — float expert stacks: the token-expert assignments sorted by
  expert, then one group of rows per expert through its up, gate and
  down matmuls (the reference's ``jax.lax.ragged_dot``, which PyTorch
  lacks, as a loop over the groups; their sizes are read to the host
  once per layer). Exact and dropless.
* ``pim`` — expert stacks programmed as
  :class:`~repro_torch.core.pim.ExpertStackedPlan` (serving's
  ``plan_params_for_pim``): every token is driven past every expert's
  stationary array through ``engine.matmul`` (up and gate broadcast, the
  down-projection paired), and the router weights apply at aggregation.
  On ``exact-cuda`` each expert's product is one launch of the PIM
  matmul kernel. Stacks split over a mesh (``engine.shard_plan``, kind
  ``"expert"``) run each rank's experts and gather them chunk by chunk,
  combined in the single-device order, so the layer's output is the
  unsplit stacks' bit for bit.
* ``ep`` — float stacks under a :class:`~repro_torch.distributed.
  sharding.ShardingContext` whose ``model`` axis is above 1 and divides
  E: every rank routes its tokens (split over the data axes where they
  divide) against its own E / ep experts, with the reference's capacity
  factor 1.25 and trash bucket, and an all-reduce over ``model`` sums the
  contributions (:func:`_moe_ep_body`).
* ``ep`` in sharded training — under a training context each rank stores
  its block of every expert stack (``launch.train.shard_state``) and runs
  the same body on it, dropless (every assignment to its experts is kept,
  so the step computes what one device computes), with its gradient: the
  tokens and router weights enter with :func:`~repro_torch.distributed.
  collectives.copy_to` and the contributions are summed with
  ``reduce_from``. Tokens are this data rank's already.

Router as in qwen3-moe: softmax over all experts, top-k, renormalize;
the Switch load-balance loss and the router z-loss go to ``aux``. When
sharded training splits the batch over the data axes, the per-expert
statistics and the z-loss are means over the data ranks before the losses
are formed, so both are the global batch's.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pim import ExpertStackedPlan
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import DATA_AXES, current_context
from repro_torch.engine import matmul as engine_matmul
from repro_torch.engine import mesh as mesh_mod
from repro_torch.models.layers import (Params, dense_init, mlp_apply,
                                       mlp_init, split_of)

# The PIM route runs the experts in chunks whose (chunk, T, width) float32
# temporaries hold at most this many elements each (512 MB): at T = 4096
# tokens of width 2048 that is 16 experts, and at decode sizes all of them.
PIM_CHUNK_ELEMENTS = 1 << 27


def moe_init(gen: torch.Generator, d_model: int, num_experts: int,
             d_ff: int, shared_experts: int = 0, shared_d_ff: int = 0,
             device=None, dtype=torch.float32) -> Params:
    """Router, expert stacks (E, D, F) / (E, F, D) and the optional shared
    experts (one gated MLP of width ``shared_experts * shared_d_ff``),
    drawn from ``gen`` in the reference's order of fields."""
    scale = 1.0 / math.sqrt(d_model)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p = {
        "router_de": dense_init(gen, d_model, num_experts, device=device),
        "wi_edf": (normal(num_experts, d_model, d_ff) * scale).to(dtype),
        "wg_edf": (normal(num_experts, d_model, d_ff) * scale).to(dtype),
        "wo_efd": (normal(num_experts, d_ff, d_model)
                   / math.sqrt(d_ff)).to(dtype),
    }
    if shared_experts > 0:
        sd = shared_d_ff or d_ff
        p["shared"] = mlp_init(gen, d_model, shared_experts * sd,
                               gated=True, device=device, dtype=dtype)
    return p


def _route(router_de: torch.Tensor, x: torch.Tensor, k: int, ctx=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """x: (T, D) -> (probs (T, k), ids (T, k), lb_loss, z_loss). Under a
    training context whose batch is split over data axes, the density,
    the mean probabilities and z are means over the data ranks."""
    logits = x.to(torch.float32) @ router_de.to(torch.float32)
    full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(full, k, dim=-1)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    e = router_de.shape[1]
    # Switch-style load-balance loss
    density = F.one_hot(ids[:, 0], e).to(torch.float32).mean(dim=0)
    mean_probs = full.mean(dim=0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if ctx is not None and ctx.batch_axes:
        stats = coll.data_mean(torch.cat([density, mean_probs, z[None]]),
                               ctx.mesh, ctx.batch_axes)
        density, mean_probs, z = stats[:e], stats[e:2 * e], stats[2 * e]
    lb = e * torch.sum(density * mean_probs)
    return probs, ids, lb, z


def expert_counts(flat_ids: torch.Tensor, experts: int,
                  num_experts: int) -> List[int]:
    """Host ints: how many of ``flat_ids`` name each expert ``0 ..
    experts - 1`` (``torch.bincount``; larger ids, such as the
    expert-parallel trash bucket, are not counted). On the meta device
    (the dry-run's shape stand-ins, which hold no ids) the assignment is
    taken as balanced: each of the ``num_experts`` experts receives
    ``n / num_experts`` of the n ids (the first ``n % num_experts`` one
    more)."""
    if not flat_ids.is_meta:
        # repro-lint: disable=RPR101 (group sizes: one a layer, float route)
        return torch.bincount(flat_ids, minlength=experts)[:experts].tolist()
    n = flat_ids.numel()
    return [n // num_experts + (e < n % num_experts) for e in range(experts)]


def _expert_ffn_local(xs: torch.Tensor, group_sizes, wi: torch.Tensor,
                      wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """xs: (R, D) rows sorted by expert; group_sizes: E host ints. Each
    expert's rows through its gated FFN, in xs's dtype."""
    out = xs.new_empty((xs.shape[0], wo.shape[-1]))
    start = 0
    for e, size in enumerate(group_sizes):
        if size:
            rows = xs[start:start + size]
            h = rows @ wi[e].to(xs.dtype)
            g = rows @ wg[e].to(xs.dtype)
            out[start:start + size] = (F.silu(g) * h) @ wo[e].to(xs.dtype)
        start += size
    return out


def _moe_local(x2: torch.Tensor, probs: torch.Tensor, ids: torch.Tensor,
               wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
               num_experts: int) -> torch.Tensor:
    """Dropless grouped-matmul MoE over a local token batch.
    x2: (T, D); probs / ids: (T, k). Returns (T, D)."""
    t, k = ids.shape
    flat_ids = ids.reshape(-1)                        # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    token_of = order // k
    xs = x2[token_of].to(torch.float32)               # (T*k, D)
    group_sizes = expert_counts(flat_ids, num_experts, num_experts)
    ys = _expert_ffn_local(xs, group_sizes, wi.to(torch.float32),
                           wg.to(torch.float32), wo.to(torch.float32))
    ys = ys * probs.reshape(-1)[order][:, None]
    # back to (token, slot) order, then each token's k contributions summed
    # (the reference scatter-adds them; this order needs no atomics)
    unsorted = torch.empty_like(ys)
    unsorted[order] = ys
    return unsorted.reshape(t, k, -1).sum(dim=1).to(x2.dtype)


def _moe_pim(x2: torch.Tensor, probs: torch.Tensor, ids: torch.Tensor,
             wi: ExpertStackedPlan, wg: ExpertStackedPlan,
             wo: ExpertStackedPlan) -> torch.Tensor:
    """Expert FFN on the PIM engine: the dropless weight-stationary
    mapping. Each expert's (D, F) / (F, D) matrices are stationary arrays;
    the whole token batch is driven past every one of them (up and gate
    broadcast, the down-projection paired) and the router weights apply
    at aggregation, with no gather or scatter of tokens.

    The reference does this over the whole (E, T, ·) stack at once; here
    the experts go in chunks of at most ``PIM_CHUNK_ELEMENTS`` per
    temporary, which keeps the peak memory of a 4096-token prefill near
    the plans' own. Each chunk's up and gate calls quantize x once for
    all of its experts, and per-row quantization of a chunk's hidden rows
    equals that of the whole stack, so the products are the reference's;
    only the float sum over experts is grouped by chunk.
    x2: (T, D); probs / ids: (T, k). Returns (T, D)."""
    t, d = x2.shape
    e = wi.num_experts
    x2f = x2.to(torch.float32)
    w = torch.zeros((t, e), dtype=torch.float32, device=x2.device)
    w.scatter_add_(1, ids, probs.to(torch.float32))
    width = max(wi.dense.n, wo.dense.n)
    chunk = max(1, min(e, PIM_CHUNK_ELEMENTS // max(1, t * width)))
    out = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
    if wi.shard is not None:
        _moe_pim_split(out, x2f, w, wi, wg, wo, chunk)
        return out.to(x2.dtype)
    for lo in range(0, e, chunk):
        hi = min(e, lo + chunk)
        _combine(out, w[:, lo:hi], _expert_chunk(x2f, wi, wg, wo, lo, hi))
    return out.to(x2.dtype)


def _expert_chunk(x2f: torch.Tensor, wi: ExpertStackedPlan,
                  wg: ExpertStackedPlan, wo: ExpertStackedPlan, lo: int,
                  hi: int) -> torch.Tensor:
    """Experts ``lo`` to ``hi - 1`` of the stacks (indices into the
    experts they hold) on the whole batch: (C, T, D)."""
    h = engine_matmul(x2f, wi.experts(lo, hi))              # (C, T, F)
    hidden = F.silu(engine_matmul(x2f, wg.experts(lo, hi))) * h
    del h
    return engine_matmul(hidden, wo.experts(lo, hi), paired=True)


def _moe_pim_split(out: torch.Tensor, x2f: torch.Tensor, w: torch.Tensor,
                   wi: ExpertStackedPlan, wg: ExpertStackedPlan,
                   wo: ExpertStackedPlan, chunk: int) -> None:
    """:func:`_moe_pim`'s loop on stacks split over a mesh (each rank holds
    E / ep experts), bit-identical to the unsplit loop.

    The single-device chunks ``[lo, lo + chunk)`` are cut at the ranks'
    expert blocks into pieces. In round j every rank computes its j-th
    piece (per-expert math, so a piece's rows equal the same experts' rows
    of the whole chunk) and an all-gather hands every rank every rank's
    j-th piece. A chunk is combined once all its pieces have arrived, in
    chunk order, as the single device combines it: the same (C, T, D)
    tensor through the same einsum, added in the same order. Pieces that
    arrive ahead of their chunk's turn wait (at prefill, the experts of the
    ranks after the first: the combine's order costs that memory)."""
    sh = wi.shard
    if any(p.shard != sh for p in (wg, wo)):
        raise ValueError("the up, gate and down expert stacks must be split "
                         "alike (engine.shard_plan_tree splits them so)")
    e = wi.num_experts
    own = e // sh.size
    local = [mesh_mod.local_experts(p) for p in (wi, wg, wo)]
    bounds = [(lo, min(e, lo + chunk)) for lo in range(0, e, chunk)]
    pieces = [[(c, max(lo, r * own), min(hi, (r + 1) * own))
               for c, (lo, hi) in enumerate(bounds)
               if max(lo, r * own) < min(hi, (r + 1) * own)]
              for r in range(sh.size)]
    waiting = {c: [] for c in range(len(bounds))}
    turn = 0
    for j in range(max(len(p) for p in pieces)):
        width = max(hi - lo for p in pieces if j < len(p)
                    for _, lo, hi in [p[j]])
        mine = pieces[sh.index][j] if j < len(pieces[sh.index]) else None
        if mine is None:
            y = out.new_zeros((width,) + tuple(out.shape))
        else:
            base = sh.index * own
            y = _expert_chunk(x2f, *local, mine[1] - base, mine[2] - base)
            if y.shape[0] < width:
                y = F.pad(y, (0, 0, 0, 0, 0, width - y.shape[0]))
        for r, part in enumerate(mesh_mod.all_gather_list(y, sh.mesh,
                                                          sh.axis)):
            if j < len(pieces[r]):
                c, lo, hi = pieces[r][j]
                waiting[c].append((lo, part[:hi - lo]))
        del y
        while turn < len(bounds) and bounds[turn][1] - bounds[turn][0] \
                == sum(p.shape[0] for _, p in waiting[turn]):
            lo, hi = bounds[turn]
            parts = sorted(waiting.pop(turn), key=lambda item: item[0])
            _combine(out, w[:, lo:hi],
                     torch.cat([p for _, p in parts]) if len(parts) > 1
                     else parts[0][1])
            turn += 1


def _combine(out: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """The aggregation: ``out (T, D) += sum_e w[:, e] * y[e]`` for router
    weights w (T, C) and expert outputs y (C, T, D)."""
    out += torch.einsum("tc,ctd->td", w, y)


def _moe_ep_body(x2: torch.Tensor, probs: torch.Tensor, ids: torch.Tensor,
                 wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, *,
                 num_experts: int, shard: int,
                 capacity_factor: Optional[float] = 1.25) -> torch.Tensor:
    """One rank's part of the expert-parallel route: ``wi`` / ``wg`` /
    ``wo`` hold this rank's E / ep experts, the ``shard``-th block. Returns
    its contribution (T, D), to be summed over the ``model`` axis.

    As in the reference: assignments to other ranks' experts go to a
    trailing trash bucket; after a stable sort by local expert only the
    first ``cap = T·k / ep · capacity_factor`` rows can be local, and
    assignments past ``cap`` drop (the standard capacity behaviour;
    ``capacity_factor=None`` keeps all T·k, dropless). The
    kept rows run through their experts in float32, as :func:`_moe_local`
    runs them, and each token's k slots are summed in slot order."""
    e_local = wi.shape[0]
    ep_size = num_experts // e_local
    t, k = ids.shape
    local = ids - shard * e_local
    valid = (local >= 0) & (local < e_local)
    flat_ids = torch.where(valid, local,
                           torch.full_like(local, e_local)).reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    cap = t * k if capacity_factor is None else \
        max(1, min(t * k, int(t * k / ep_size * capacity_factor)))
    keep = order[:cap]                       # local assignments sort first
    counts = expert_counts(flat_ids, e_local, num_experts)
    cum = [min(c, cap) for c in itertools.accumulate(counts)]
    group_sizes = [b - a for a, b in zip([0] + cum[:-1], cum)]
    rows = cum[-1] if cum else 0
    ys = torch.zeros((cap, x2.shape[1]), dtype=torch.float32,
                     device=x2.device)
    if rows:
        xs = x2[keep[:rows] // k].to(torch.float32)
        ys[:rows] = _expert_ffn_local(xs, group_sizes, wi.to(torch.float32),
                                      wg.to(torch.float32),
                                      wo.to(torch.float32))
    wts = probs.reshape(-1)[keep] * valid.reshape(-1)[keep].to(torch.float32)
    slots = torch.zeros((t * k, x2.shape[1]), dtype=torch.float32,
                        device=x2.device)
    slots[keep] = ys * wts[:, None]
    return slots.reshape(t, k, -1).sum(dim=1).to(x2.dtype)


def _moe_ep(x2: torch.Tensor, probs: torch.Tensor, ids: torch.Tensor,
            wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
            num_experts: int, mesh) -> torch.Tensor:
    """The expert-parallel route over ``mesh``'s ``model`` axis: tokens
    split over the data axes where they divide (else every rank takes
    them all), this rank's block of experts, the contributions summed over
    ``model`` and the token blocks gathered back."""
    axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    split = bool(axes) and mesh.size(axes) > 1 and \
        x2.shape[0] % mesh.size(axes) == 0
    if split:
        per = x2.shape[0] // mesh.size(axes)
        rows = slice(mesh.index(axes) * per, (mesh.index(axes) + 1) * per)
        x2, probs, ids = x2[rows], probs[rows], ids[rows]
    own = num_experts // mesh.shape["model"]
    mine = slice(mesh.coords["model"] * own, (mesh.coords["model"] + 1) * own)
    out = _moe_ep_body(x2, probs, ids, wi[mine], wg[mine], wo[mine],
                       num_experts=num_experts, shard=mesh.coords["model"])
    out = mesh_mod.all_reduce(out, mesh, "model")
    return mesh_mod.all_gather(out, mesh, axes, dim=0) if split else out


def _moe_ep_split(x2: torch.Tensor, probs: torch.Tensor,
                  ids: torch.Tensor, p: Params, num_experts: int, split
                  ) -> torch.Tensor:
    """Sharded training's expert-parallel route: this rank's stored block
    of experts on this data rank's tokens, dropless, the contributions
    summed over the split's axis."""
    mesh, axis, _ = split
    out = _moe_ep_body(coll.copy_to(x2, mesh, axis),
                       coll.copy_to(probs, mesh, axis), ids, p["wi_edf"],
                       p["wg_edf"], p["wo_efd"], num_experts=num_experts,
                       shard=mesh.index(axis), capacity_factor=None)
    return coll.reduce_from(out, mesh, axis)


def moe_apply(p: Params, x: torch.Tensor, experts_per_token: int,
              aux: Optional[dict] = None) -> torch.Tensor:
    """MoE FFN. x: (B, S, D) -> (B, S, D). The route follows the params
    and the sharding context: programmed expert stacks run on the engine;
    float stacks run the expert-parallel route under a context whose
    ``model`` axis is above 1 and divides E, or under a training context
    that stores them split, else the local grouped route.
    The router losses are added to ``aux``'s ``moe_lb_loss`` and
    ``moe_z_loss`` when it is given."""
    b, s, d = x.shape
    wi_edf = p["wi_edf"]
    pim_experts = isinstance(wi_edf, ExpertStackedPlan)
    num_experts = wi_edf.num_experts if pim_experts else wi_edf.shape[0]
    x2 = x.reshape(-1, d)
    ctx = current_context()
    probs, ids, lb, z = _route(p["router_de"], x2, experts_per_token, ctx)
    if aux is not None:
        aux["moe_lb_loss"] = aux.get("moe_lb_loss", 0.0) + lb
        aux["moe_z_loss"] = aux.get("moe_z_loss", 0.0) + z
    split = None if pim_experts else split_of(wi_edf, "wi_edf")
    if pim_experts:
        out2 = _moe_pim(x2, probs, ids, wi_edf, p["wg_edf"], p["wo_efd"])
    elif split is not None:
        out2 = _moe_ep_split(x2, probs, ids, p, p["router_de"].shape[1],
                             split)
    elif ctx is not None and ctx.splits is None and \
            "model" in ctx.mesh.axis_names and \
            ctx.mesh.shape["model"] > 1 and \
            num_experts % ctx.mesh.shape["model"] == 0:
        out2 = _moe_ep(x2, probs, ids, wi_edf, p["wg_edf"], p["wo_efd"],
                       num_experts, ctx.mesh)
    else:
        out2 = _moe_local(x2, probs, ids, wi_edf, p["wg_edf"], p["wo_efd"],
                          num_experts)
    out = out2.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out


def moe_reference(p: Params, x: torch.Tensor, experts_per_token: int
                  ) -> torch.Tensor:
    """Dense oracle: every expert evaluated for every token (tests only)."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d).to(torch.float32)
    probs, ids, _, _ = _route(p["router_de"], x2, experts_per_token)
    h = torch.einsum("td,edf->tef", x2, p["wi_edf"].to(torch.float32))
    g = torch.einsum("td,edf->tef", x2, p["wg_edf"].to(torch.float32))
    y = torch.einsum("tef,efd->ted", F.silu(g) * h,
                     p["wo_efd"].to(torch.float32))
    w = torch.zeros((x2.shape[0], p["wi_edf"].shape[0]),
                    dtype=torch.float32, device=x.device)
    w.scatter_add_(1, ids, probs)
    out = torch.einsum("te,ted->td", w, y).to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out
