"""Mesh-sharded execution of programmed PIM plans (counterpart of
``repro/engine/mesh.py``).

A real OPIMA deployment is a wall of independent optical arrays: its
throughput rests on many banks in flight, not on one array's speed. This
module maps that onto a :class:`~repro_torch.launch.mesh.Mesh` of SPMD
ranks: a plan's stationary planes are split across the ranks once, at
programming time, each rank keeping only its slice, and ``engine.matmul``
runs each rank's part followed by the collective that gives every rank
the whole output. The split is stamped into the plan as a
:class:`PlanShard`, so call sites carry no flags and model code stays
unaware of the mesh.

Three split kinds, as in the JAX package (``_dh`` column-parallel, ``_hd``
row-parallel, ``_edf`` / ``_efd`` expert stacks):

  ``col``     a DensePlan split along N. Each rank holds all of K and a
              block of columns, runs the unchanged substrate math on it
              (``exact-cuda``: the PIM matmul kernel, bias slice fused),
              and an all-gather along N joins the blocks. Bit-identical to
              one device on the exact substrates: each output column's
              arithmetic is untouched by the split.
  ``row``     a DensePlan split along the padded K. Activations are
              quantized per row as on one device, each rank contracts its
              K block to a raw int32 accumulator (``exact-cuda``: the
              kernel's int32 entry point, B2), an all-reduce sums the
              partials (integer addition, exact in any order), then one
              dequant, ``acc * a_scale * w_scale`` and a separate bias add:
              bit-identical to the fused epilogue on the exact substrates.
  ``expert``  an ExpertStackedPlan split along its experts. Each rank
              drives its sub-stack with the substrate's own per-expert
              math and an all-gather along E rebuilds the (E, ..., N)
              output, bit-identical on every substrate (the analog
              auto-range is per expert already).

The analog substrates refuse dense splits: their ADC full scale is a
global max over the whole output, so a shard would range a different lsb.
Sharded plans are verify-free, as in the JAX package: placement drops the
ABFT checksum record. Rows split over the data axes where M divides
(per-row quantization keeps the bits) and are gathered back.

Data layout. A stamped plan keeps the global ``k`` and ``n``; its tensor
fields hold this rank's slice, stored as contiguous copies (the kernels
take contiguous planes, and the whole plan's storage is freed). The
global geometry is the JAX package's: ``col`` trims the N padding before
the split, ``row`` pads Kp to a multiple of the axis size. Plan
directories store the global leaves (:mod:`repro_torch.engine.persist`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import pim
from repro_torch.distributed.sharding import DATA_AXES, logical_rules

SHARD_KINDS = ("col", "row", "expert")

# collectives issued by the executors, by kind (a run's count of them)
COLLECTIVES: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}


@dataclasses.dataclass(frozen=True)
class PlanShard:
    """How a plan's stationary leaves are split over a mesh: ``kind`` one
    of :data:`SHARD_KINDS`, ``axis`` the mesh axis the stationary
    dimension splits over (conventionally ``"model"``)."""

    kind: str
    axis: str
    mesh: Any

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        """This rank's block along the axis."""
        return self.mesh.coords[self.axis]

    def block(self, total: int) -> slice:
        """This rank's slice of a dimension of ``total`` split evenly."""
        per = total // self.size
        return slice(self.index * per, (self.index + 1) * per)


def reset_collectives() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def all_gather_list(t: torch.Tensor, mesh, axes) -> List[torch.Tensor]:
    """``t`` from every rank along ``axes``, in rank order (``[t]`` where
    the axes span one rank). Every rank passes a tensor of one shape."""
    group = mesh.group(axes)
    if group is None:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, t, group=group)
    COLLECTIVES["all_gather"] += 1
    return parts


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``t`` from every rank along ``axes``, joined along ``dim`` in rank
    order."""
    parts = all_gather_list(t, mesh, axes)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, in place."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES["all_reduce"] += 1
    return t


def _data_axes(mesh, m: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the flattened batch/token dim splits over (data
    parallelism riding along a tensor-split matmul), or None when ``m``
    does not divide evenly: every rank then takes every row."""
    axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    if not axes:
        return None
    total = mesh.size(axes)
    return axes if total > 1 and m % total == 0 else None


def _my_rows(x2: torch.Tensor, mesh, axes) -> torch.Tensor:
    if axes is None:
        return x2
    per = x2.shape[0] // mesh.size(axes)
    i = mesh.index(axes)
    return x2[i * per:(i + 1) * per]


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy with storage of its own (a slice must not keep the
    whole plan's storage alive)."""
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Programming time: stamp and keep this rank's slice
# ---------------------------------------------------------------------------
def shard_dense_plan(plan: pim.DensePlan, mesh, kind: str,
                     axis: str = "model") -> pim.DensePlan:
    """Split a DensePlan over ``mesh[axis]``, keeping this rank's slice.

    ``col`` trims the N padding first so that the blocks never interleave
    pad columns; ``row`` pads the stationary K so that it splits evenly
    (zero rows are exact on the integer datapath) and keeps the codes and
    scales whole. Raises when the plan's substrate cannot stay
    bit-identical under the split, or N does not divide."""
    if kind not in ("col", "row"):
        raise ValueError(f"dense plans shard 'col' or 'row', got {kind!r}")
    if plan.shard is not None:
        raise ValueError(f"plan is already split ({plan.shard.kind} over "
                         f"{plan.shard.axis!r})")
    tp = mesh.shape[axis]
    if tp == 1:
        return plan
    # substrates imports this module: look the registry up at call time
    from repro_torch.engine.substrates import (available_substrates,
                                               get_substrate)
    if kind not in get_substrate(plan.substrate).dense_splits:
        able = [s for s in available_substrates()
                if kind in get_substrate(s).dense_splits]
        raise ValueError(
            f"substrate {plan.substrate!r} cannot {kind}-split a dense plan"
            " bit-identically (an analog ADC's auto-range is a global max; "
            "a row split's all-reduce is exact only on the raw int32 "
            f"accumulator); use kind='expert' plans or one of {able}")
    shard = PlanShard(kind=kind, axis=axis, mesh=mesh)
    values, scale = plan.values, plan.scale
    planes, padded_scale = plan.planes, plan.padded_scale
    if kind == "col":
        if plan.n % tp:
            raise ValueError(
                f"col split needs n ({plan.n}) divisible by "
                f"mesh[{axis!r}]={tp}")
        cols = shard.block(plan.n)
        values, scale = _own(values[..., cols]), _own(scale[..., cols])
        planes = _own(planes[..., :plan.n][..., cols])
        padded_scale = _own(padded_scale[..., :plan.n][..., cols])
    else:
        pad = (-planes.shape[-2]) % tp
        if pad:
            planes = F.pad(planes, (0, 0, 0, pad))
        planes = _own(planes[..., shard.block(planes.shape[-2]), :])
    return pim.DensePlan(values=values, scale=scale, planes=planes,
                         padded_scale=padded_scale, bits=plan.bits,
                         k=plan.k, n=plan.n, cfg=plan.cfg, shard=shard)


def shard_expert_plan(plan: pim.ExpertStackedPlan, mesh,
                      axis: str = "model") -> pim.ExpertStackedPlan:
    """Expert-parallel placement: this rank keeps its block of experts of
    every stacked leaf. Exact on every substrate."""
    if plan.shard is not None:
        raise ValueError(f"plan is already split ({plan.shard.kind} over "
                         f"{plan.shard.axis!r})")
    tp = mesh.shape[axis]
    if tp == 1:
        return plan
    if plan.num_experts % tp:
        raise ValueError(
            f"expert split needs num_experts ({plan.num_experts}) "
            f"divisible by mesh[{axis!r}]={tp}")
    shard = PlanShard(kind="expert", axis=axis, mesh=mesh)
    d = plan.dense
    mine = shard.block(plan.num_experts)
    dense = pim.DensePlan(
        values=_own(d.values[mine]), scale=_own(d.scale[mine]),
        planes=_own(d.planes[mine]),
        padded_scale=_own(d.padded_scale[mine]), bits=d.bits, k=d.k,
        n=d.n, cfg=d.cfg)
    return pim.ExpertStackedPlan(dense=dense, num_experts=plan.num_experts,
                                 shard=shard)


def shard_plan(plan: pim.Plan, mesh, kind: Optional[str] = None,
               axis: str = "model") -> pim.Plan:
    """Stamp and split one plan. ``kind=None`` picks the natural default:
    ``expert`` for expert stacks, ``col`` for dense plans."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}; axes: "
                         f"{mesh.axis_names}")
    if isinstance(plan, pim.ExpertStackedPlan):
        if kind not in (None, "expert"):
            raise ValueError(
                f"expert stacks shard kind='expert', got {kind!r}")
        return shard_expert_plan(plan, mesh, axis)
    if isinstance(plan, pim.DensePlan):
        return shard_dense_plan(plan, mesh, kind or "col", axis)
    raise NotImplementedError(
        f"{type(plan).__name__} has no mesh placement (depthwise filters "
        "are below one WDM chunk; shard the channel batch instead)")


def _kind_from_rules(name: str, mesh, is_expert: bool) -> Optional[str]:
    """The split kind for a parameter name, from the logical-rule table
    of :mod:`repro_torch.distributed.sharding`: the one source of which
    matmul dimension the 'model' axis partitions."""
    rules = logical_rules(mesh)
    leaf = name[2:] if name.startswith("s_") else name
    if is_expert:
        return "expert"
    for suffix, key in (("_dh", "w_dh"), ("_hd", "w_hd")):
        if leaf.endswith(suffix):
            spec = tuple(rules[key])
            if spec[-1] == "model":
                return "col"
            if spec[0] == "model":
                return "row"
    return None


def place_plan_tree(tree: Any, mesh, axis: str = "model"
                    ) -> Tuple[Any, List[str]]:
    """:func:`shard_plan_tree`'s walk: the placed tree and the names of
    the plans it replicated. Plans are placed by leaf name wherever they
    sit (an encoder's ``enc_layers``, a decoder's ``xattn``); float
    leaves, such as the VLM's fake-quantized ``vproj_dh``, stay whole."""
    replicated: List[str] = []

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [walk(v, name) for v in node]
            return items if isinstance(node, list) else tuple(items)
        if isinstance(node, pim.Plan):
            kind = _kind_from_rules(
                name, mesh, isinstance(node, pim.ExpertStackedPlan))
            if kind is not None:
                try:
                    return shard_plan(node, mesh, kind, axis)
                except ValueError:
                    pass        # the geometry does not divide: replicate
            replicated.append(name)
        return node

    return walk(tree, ""), replicated


def shard_plan_tree(tree: Any, mesh, axis: str = "model") -> Any:
    """Place every plan of a planned parameter tree (the
    ``plan_params_for_pim`` output) on the mesh: tensor-split where the
    naming convention names a split and the geometry divides, replicated
    otherwise; other leaves stay whole on every rank. Never raises for a
    plan that does not split; the count of replicated plans is printed
    (on rank 0)."""
    placed, replicated = place_plan_tree(tree, mesh, axis)
    report_replicated(replicated, mesh)
    return placed


def report_replicated(names: List[str], mesh) -> None:
    """Print (on rank 0) how many plans of each name stayed whole."""
    if names and mesh.rank == 0:
        print(f"[engine.mesh] replicated {len(names)} plan(s): " + ", ".join(
            f"{n} x{c}" for n, c in collections.Counter(names).items()))


# ---------------------------------------------------------------------------
# Execution: each rank's part, then the collective
# ---------------------------------------------------------------------------
def _local_dense(plan: pim.DensePlan, n: int) -> pim.DensePlan:
    """The rank's slice of a stamped dense plan as an unstamped plan of
    ``n`` columns (verify-free)."""
    return dataclasses.replace(plan, n=n, abft=None, shard=None)


def local_experts(plan: pim.ExpertStackedPlan) -> pim.ExpertStackedPlan:
    """The rank's experts of a stamped stack as an unstamped stack."""
    return pim.ExpertStackedPlan(dense=plan.dense,
                                 num_experts=plan.dense.values.shape[0])


def _col_matmul(sub, x: torch.Tensor, plan: pim.DensePlan,
                cfg: pim.PimConfig, bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Column split: each rank computes its own complete output columns
    with the unchanged substrate math; the all-gather joins them."""
    sh = plan.shard
    mesh = sh.mesh
    orig = tuple(x.shape)
    x2 = x.reshape(-1, plan.k)
    rows = _data_axes(mesh, x2.shape[0])
    cols = sh.block(plan.n)
    local = _local_dense(plan, cols.stop - cols.start)
    b = None if bias is None else bias.reshape(-1)[cols]
    y = sub._dense2d(_my_rows(x2, mesh, rows), local, cfg, b, None)
    y = all_gather(y, mesh, sh.axis, dim=1)
    if rows is not None:
        y = all_gather(y, mesh, rows, dim=0)
    return y.reshape(orig[:-1] + (plan.n,))


def act_block(a_planes: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Columns ``[lo, lo + width)`` of the activation planes, zero past
    their K (the plan's K padding), as the contiguous block the kernel
    takes: a copy on every call."""
    k = a_planes.shape[-1]
    hi = min(k, lo + width)
    if hi - lo == width:
        return a_planes[..., lo:hi].contiguous()
    out = a_planes.new_zeros(a_planes.shape[:-1] + (width,))
    if hi > lo:
        out[..., :hi - lo] = a_planes[..., lo:hi]
    return out


def _row_matmul(sub, x: torch.Tensor, plan: pim.DensePlan,
                cfg: pim.PimConfig, bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Row (K) split: per-row activation quantization, each rank's raw
    int32 contraction of its K block (``exact-cuda``: B2), one exact
    integer all-reduce, then the dequant epilogue in the fused kernel's
    operation order, ``(acc * a_scale) * w_scale``, and a separate bias
    add: bit-identical to both single-device exact routes."""
    sh = plan.shard
    mesh = sh.mesh
    orig = tuple(x.shape)
    x2 = x.reshape(-1, plan.k)
    rows = _data_axes(mesh, x2.shape[0])
    a_q, a_planes = pim._quantize_activations(_my_rows(x2, mesh, rows), cfg)
    width = plan.planes.shape[-2]
    a_blk = act_block(a_planes, sh.index * width, width)
    acc = all_reduce(sub._dense_int(a_blk, plan.planes), mesh, sh.axis)
    out = acc[:, :plan.n].to(torch.float32) * a_q.scale * plan.scale
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(1, -1)
    if rows is not None:
        out = all_gather(out, mesh, rows, dim=0)
    return out.reshape(orig[:-1] + (plan.n,))


def _expert_matmul(sub, x: torch.Tensor, plan: pim.ExpertStackedPlan,
                   cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                   paired: bool) -> torch.Tensor:
    """Expert split: each rank drives its own experts with the substrate's
    per-expert math, and an all-gather along E rebuilds the single-device
    (E, ..., N) output, so the MoE combine downstream is unchanged."""
    sh = plan.shard
    if paired:
        if x.dim() < 2 or x.shape[0] != plan.num_experts:
            raise ValueError(
                f"paired expert input needs a leading ({plan.num_experts},"
                f" ...) axis, got {tuple(x.shape)}")
        x = x[sh.block(plan.num_experts)]
    y = sub._experts(x, local_experts(plan), cfg, bias, None, paired)
    return all_gather(y, sh.mesh, sh.axis, dim=0)


def sharded_matmul(sub, x: torch.Tensor, plan: pim.Plan, *,
                   cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                   rng: Optional[torch.Generator],
                   paired: bool) -> torch.Tensor:
    """Dispatch a mesh-stamped plan to its split executor; reached from
    :meth:`repro_torch.engine.substrates.Substrate.matmul` when
    ``plan.shard`` is set."""
    sh = plan.shard
    if rng is not None:
        raise NotImplementedError(
            "stochastic analog read noise is not supported on mesh-"
            "sharded plans; program the noise-study plan without a mesh")
    if isinstance(plan, pim.ExpertStackedPlan):
        return _expert_matmul(sub, x, plan, cfg, bias, paired)
    if paired:
        raise ValueError("paired=True is only meaningful for "
                         "ExpertStackedPlan")
    if sh.kind == "col":
        return _col_matmul(sub, x, plan, cfg, bias)
    if sh.kind == "row":
        return _row_matmul(sub, x, plan, cfg, bias)
    raise ValueError(f"unknown shard kind {sh.kind!r} on "
                     f"{type(plan).__name__}")


# ---------------------------------------------------------------------------
# Global geometry (plan directories store the whole leaves)
# ---------------------------------------------------------------------------
def _split_dim(shard: Optional[PlanShard], field: str) -> Optional[int]:
    """The dimension of a plan field (``values``, ``scale``, ``planes``,
    ``padded_scale``) that ``shard`` splits, or None: an expert split's
    leading axis, a column split's last, a row split's K of the planes
    (its codes and scales stay whole)."""
    if shard is None:
        return None
    if shard.kind == "expert":
        return 0
    if shard.kind == "col":
        return -1
    return -2 if field == "planes" else None


def global_shape(plan: pim.DensePlan, shard: Optional[PlanShard],
                 field: str) -> Tuple[int, ...]:
    """The whole leaf's shape of ``field`` of a (possibly stamped) dense
    plan; ``shard`` is the plan's own or, for the dense plan of an
    expert stack, the stack's."""
    shape = list(getattr(plan, field).shape)
    dim = _split_dim(shard, field)
    if dim is not None:
        shape[dim] *= shard.size
    return tuple(shape)


def gather_leaf(t: torch.Tensor, shard: Optional[PlanShard],
                field: str) -> torch.Tensor:
    """The whole leaf of a stamped plan's ``field`` from the ranks along
    the split axis (collective: every rank on the axis calls it); ``t``
    where the field is not split."""
    dim = _split_dim(shard, field)
    if dim is None:
        return t
    return all_gather(t, shard.mesh, shard.axis, dim=dim % t.dim())


__all__ = ["COLLECTIVES", "PlanShard", "SHARD_KINDS", "act_block",
           "all_gather", "all_gather_list", "all_reduce",
           "gather_leaf", "global_shape", "local_experts",
           "place_plan_tree", "reset_collectives",
           "shard_dense_plan", "shard_expert_plan", "shard_plan",
           "shard_plan_tree", "sharded_matmul"]
