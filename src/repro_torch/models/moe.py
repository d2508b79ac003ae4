"""Mixture-of-Experts FFN: top-k router + dropless expert FFNs
(counterpart of ``repro/models/moe.py``).

Two execution paths, chosen by the params themselves, as in the JAX
package:

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
  matmul kernel.

The reference's third path, expert parallelism over a mesh axis
(``_moe_ep_body``), waits for the port's mesh slice (ROADMAP A11):
``moe_apply`` has no mesh branch.

Router as in qwen3-moe: softmax over all experts, top-k, renormalize;
the Switch load-balance loss and the router z-loss go to ``aux``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pim import ExpertStackedPlan
from repro_torch.engine import matmul as engine_matmul
from repro_torch.models.layers import Params, dense_init, mlp_apply, mlp_init

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


def _route(router_de: torch.Tensor, x: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """x: (T, D) -> (probs (T, k), ids (T, k), lb_loss, z_loss)."""
    logits = x.to(torch.float32) @ router_de.to(torch.float32)
    full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(full, k, dim=-1)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    e = router_de.shape[1]
    # Switch-style load-balance loss
    density = F.one_hot(ids[:, 0], e).to(torch.float32).mean(dim=0)
    mean_probs = full.mean(dim=0)
    lb = e * torch.sum(density * mean_probs)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return probs, ids, lb, z


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
    group_sizes = torch.bincount(flat_ids, minlength=num_experts).tolist()
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
    for lo in range(0, e, chunk):
        hi = min(e, lo + chunk)
        h = engine_matmul(x2f, wi.experts(lo, hi))          # (C, T, F)
        hidden = F.silu(engine_matmul(x2f, wg.experts(lo, hi))) * h
        del h
        y = engine_matmul(hidden, wo.experts(lo, hi), paired=True)
        del hidden
        _combine(out, w[:, lo:hi], y)
        del y
    return out.to(x2.dtype)


def _combine(out: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """The aggregation: ``out (T, D) += sum_e w[:, e] * y[e]`` for router
    weights w (T, C) and expert outputs y (C, T, D)."""
    out += torch.einsum("tc,ctd->td", w, y)


def moe_apply(p: Params, x: torch.Tensor, experts_per_token: int,
              aux: Optional[dict] = None) -> torch.Tensor:
    """MoE FFN. x: (B, S, D) -> (B, S, D). The route follows the params:
    programmed expert stacks run on the engine, float stacks the local
    grouped route. The router losses are added to ``aux``'s
    ``moe_lb_loss`` and ``moe_z_loss`` when it is given. There is no
    expert-parallel (mesh) branch yet (ROADMAP A11)."""
    b, s, d = x.shape
    wi_edf = p["wi_edf"]
    pim_experts = isinstance(wi_edf, ExpertStackedPlan)
    num_experts = wi_edf.num_experts if pim_experts else wi_edf.shape[0]
    x2 = x.reshape(-1, d)
    probs, ids, lb, z = _route(p["router_de"], x2, experts_per_token)
    if aux is not None:
        aux["moe_lb_loss"] = aux.get("moe_lb_loss", 0.0) + lb
        aux["moe_z_loss"] = aux.get("moe_z_loss", 0.0) + z
    if pim_experts:
        out2 = _moe_pim(x2, probs, ids, wi_edf, p["wg_edf"], p["wo_efd"])
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
