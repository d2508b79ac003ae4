"""AdamW, learning-rate schedules and global-norm clipping (counterpart of
``repro/optim/adamw.py``).

As in the JAX package, the schedule, the bias corrections and the clip
scale are float32 tensors (``b1 ** step`` in float32, not in Python's
float64), so both packages round them alike; they stay on the device, so
an update makes no host sync. Unlike the JAX package, the update runs in
place over the flat leaf list (parameters, first and second moments):
the port saves the copies that JAX's functional update makes.

Sharded training passes ``splits`` (a :class:`~repro_torch.distributed.
collectives.LeafSplits`): each rank updates its shards in place, and the
clip's global norm sums each split leaf's squares over the axis and
counts each replicated leaf once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.collectives import LeafSplits
from repro_torch.tree import leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def global_norm(tree: PyTree, splits: Optional[LeafSplits] = None
                ) -> torch.Tensor:
    """The L2 norm over every leaf; with ``splits``, of the whole leaves
    (a split leaf's sum of squares summed over its axis)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    if splits is not None:
        sums = splits.reduce(sums, "sum")
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale, tree), norm


def adamw_init(params: PyTree) -> AdamWState:
    zeros = lambda: tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step=step, mu=zeros(), nu=zeros())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
                 params: PyTree, splits: Optional[LeafSplits] = None
                 ) -> Tuple[PyTree, AdamWState, Dict[str, Any]]:
    """One AdamW step. ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned, with the new step count; the metrics
    (``grad_norm`` before clipping, ``lr``) are 0-d device tensors.
    ``splits`` marks the leaves stored split over a mesh axis."""
    gnorm = global_norm(grads, splits)
    clip = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                          leaves(state.nu), leaves(params)):
        g = g.to(torch.float32)
        if clip is not None:         # clip_by_global_norm, leaf by leaf
            g = g * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
