"""Collectives over the axes of a :class:`~repro_torch.launch.mesh.Mesh`
for sharded training, with the adjoints a tensor-parallel step needs.

``torch.distributed``'s collectives carry no gradient, and the adjoint of
a collective depends on what consumes its output: the same all-gather
needs a slice as its backward when the computation after it is replicated
(every rank computes the same thing from the whole tensor) and a
reduce-scatter when each rank consumes it in its own way. So the model
code marks every crossing between replicated and rank-specific work with
one of these functions (each a ``torch.autograd.Function``):

  ===================  =====================  ===========================
  function             forward                backward
  ===================  =====================  ===========================
  :func:`copy_to`      identity               all-reduce (sum)
  :func:`reduce_from`  all-reduce (sum)       identity
  :func:`gather_from`  all-gather along dim   this rank's slice
  :func:`scatter_to`   this rank's slice      all-gather along dim
  :func:`data_mean`    mean over the ranks    identity
  ===================  =====================  ===========================

``copy_to`` enters rank-specific work from a replicated tensor (a column
split's input, a replicated parameter applied to this rank's heads): each
rank's gradient is a partial sum. ``reduce_from`` leaves it through a sum
(a row split's output). A gather whose output feeds rank-specific work
(K/V gathered for this rank's query heads) is ``gather_from`` followed,
after any replicated work on the whole tensor (qk-norm, RoPE), by
``copy_to``: the two backwards together are the reduce-scatter.
``data_mean`` takes a statistic to its mean over the data ranks; its
backward is the identity because every data rank's gradient is averaged
over the data ranks after the backward pass.

Every sum is an all-gather followed by adds in rank order, so every rank
of the axis ends with the same bits whatever the backend's reduction
order: a replicated leaf's gradient, and so the leaf after its update,
is bit-identical across the model axis. The maximum is exact in any order
and uses the backend's all-reduce. A collective that the process group's
backend cannot run on the tensor's device raises; nothing moves a tensor
to another device.

:data:`COLLECTIVES` counts the calls by kind, as ``engine.mesh``'s table
counts the serving executors'. Every call goes through :func:`_run`, the
one place an instrumented run wraps to time them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                               "all_reduce_max": 0}


def reset_collectives() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def _run(kind: str, t: torch.Tensor, fn):
    """Run the collective ``fn`` (on tensor ``t``) and count it."""
    out = fn()
    COLLECTIVES[kind] += 1
    return out


def _parts(t: torch.Tensor, mesh, axes, kind: str) -> List[torch.Tensor]:
    """``t`` from every rank along ``axes``, in rank order (``[t]`` where
    the axes span one rank)."""
    group = mesh.group(axes)
    if group is None:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axes))]
    _run(kind, t, lambda: dist.all_gather(parts, t, group=group))
    return parts


def all_reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, added in rank order
    (the same bits on every rank). No gradient."""
    parts = _parts(t, mesh, axes, "all_reduce")
    return parts[0] if len(parts) == 1 else functools.reduce(torch.add,
                                                             parts)


def all_reduce_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks along ``axes`` (a
    new tensor). No gradient."""
    group = mesh.group(axes)
    if group is None:
        return t
    out = t.detach().clone()
    _run("all_reduce_max", out, lambda: dist.all_reduce(
        out, op=dist.ReduceOp.MAX, group=group))
    return out


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``t`` from every rank along ``axes``, joined along ``dim`` in rank
    order. No gradient."""
    parts = _parts(t, mesh, axes, "all_gather")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def local_block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, split evenly over
    ``axes`` (a view)."""
    n = mesh.size(axes)
    if n == 1:
        return t
    per = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * per, per)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (local_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return local_block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes) / mesh.size(axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class LeafSplits(NamedTuple):
    """Which leaves of a tree (in flatten order) this rank stores split
    over ``axis`` of ``mesh``: the optimizer's global norm and the
    compression's whole-leaf scale reduce those over the axis."""

    mesh: Any
    axis: str
    split: Sequence[bool]

    def reduce(self, values: List[torch.Tensor], op: str
               ) -> List[torch.Tensor]:
        """``values`` (one 0-d tensor per leaf) with the split leaves'
        entries summed (``op="sum"``) or maxed (``"max"``) over the axis,
        all of them in one collective."""
        idx = [i for i, s in enumerate(self.split) if s]
        if not idx:
            return values
        packed = torch.stack([values[i] for i in idx])
        packed = all_reduce_sum(packed, self.mesh, self.axis) if op == "sum" \
            else all_reduce_max(packed, self.mesh, self.axis)
        out = list(values)
        for j, i in enumerate(idx):
            out[i] = packed[j]
        return out


def _spans(mesh, axes) -> bool:
    return mesh.size(axes) > 1


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``axes``."""
    return _CopyTo.apply(x, mesh, axes) if _spans(mesh, axes) else x


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` forward; the gradient passed through."""
    return _ReduceFrom.apply(x, mesh, axes) if _spans(mesh, axes) else x


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of every rank joined along ``dim``, for replicated work;
    the gradient's own block back."""
    return _GatherFrom.apply(x, mesh, axes, dim % x.dim()) \
        if _spans(mesh, axes) else x


def scatter_to(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of a replicated tensor along ``dim``; the
    gradient's blocks gathered from every rank."""
    return _ScatterTo.apply(x, mesh, axes, dim % x.dim()) \
        if _spans(mesh, axes) else x


def data_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks along ``axes``; the gradient passed
    through (each data rank's gradient is averaged afterwards)."""
    return _DataMean.apply(x, mesh, axes) if _spans(mesh, axes) else x


__all__ = ["COLLECTIVES", "LeafSplits", "all_gather", "all_reduce_max",
           "all_reduce_sum", "copy_to", "data_mean", "gather_from",
           "local_block", "reduce_from", "reset_collectives", "scatter_to"]
