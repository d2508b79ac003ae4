"""Mesh axes, sharding rules and the active sharding context
(counterpart of ``repro/distributed/sharding.py``).

Axis convention, as in the JAX package:
  pod    — outermost data-parallel axis across pods
  data   — data parallel within a pod
  model  — tensor parallel: attention heads, FFN hidden, vocab; MoE experts
           (expert parallelism reuses this axis)

The rule table maps logical names to :class:`PartitionSpec`s, the JAX
package's table entry for entry. In the port's SPMD model every rank runs
the whole program over a :class:`~repro_torch.launch.mesh.Mesh`; a spec is
a record of which dimension an axis splits, read by the plan placement of
:mod:`repro_torch.engine.mesh` (``_kind_from_rules``), by the MoE
expert-parallel branch and by sharded training, not a layout that a
compiler enforces.

Sharded training (``launch.train.make_train_step(..., mesh=)``) installs a
context with ``splits``: the float leaves each rank stores split, looked
up by leaf name and the rank's local shape (:meth:`ShardingContext.
split_of`). The model's call sites name the leaf they pass
(``layers.proj(x, p["wq_dh"], "wq_dh")``), and the split follows from the
table; without such a context every call site runs its single-device
code.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

_state = threading.local()

DATA_AXES = ("pod", "data")     # combined batch axes when pod is present


class PartitionSpec(tuple):
    """Stand-in for ``jax.sharding.PartitionSpec``: one entry per array
    dimension, each a mesh axis name, a tuple of names, or None
    (not split). As JAX does, a tuple of one name is stored as the name
    and an empty tuple as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def logical_rules(mesh) -> Dict[str, P]:
    """Logical activation/param spec table for the given mesh (anything
    with ``axis_names``)."""
    b = _batch_axes(mesh)
    batch = b if b else None
    return {
        # activations
        "act_btd": P(batch, None, None),            # (batch, seq, d)
        "act_btf": P(batch, None, "model"),         # ffn hidden
        "act_bthd": P(batch, None, "model", None),  # per-head activations
        "act_bthd_hd": P(batch, None, None, "model"),  # head_dim-sharded
        "act_btv": P(batch, None, "model"),         # logits (vocab sharded)
        "kv_cache": P(batch, None, "model", None),  # (batch, seq, kv, hd)
        "kv_cache_hd": P(batch, None, None, "model"),  # MQA: shard head_dim
        # decode-time caches: the sequence dim on 'model' (flash-decode)
        "kv_cache_decode": P(batch, "model", None, None),
        "kv_cache_decode_b1": P(None, ("data", "model"), None, None),
        "ssm_state": P(batch, "model", None, None),  # (batch, heads, n, p)
        "ssm_state_hd": P(batch, None, None, "model"),
        # params
        "emb_vd": P("model", None),
        "w_dh": P(None, "model"),                   # d_model -> heads*hd / ff
        "w_hd": P("model", None),                   # heads*hd / ff -> d_model
        "bias_h": P("model"),
        "bias_d": P(None),
        "norm_d": P(None),
        "moe_edf": P("model", None, None),          # experts sharded (EP)
        "moe_efd": P("model", None, None),
        "replicated": P(),
    }


class ShardingContext:
    """A mesh and its rule table, installed with :func:`use_sharding`.

    ``splits`` (sharded training only) maps ``(leaf name, local shape)``
    to the :class:`PartitionSpec` of each float leaf a rank stores split
    (a per-layer shape: the layer axis dropped); ``batch_axes`` names the
    mesh axes the batch is split over (empty when every rank takes the
    whole batch). Serving's contexts leave both unset."""

    def __init__(self, mesh, splits: Optional[Dict[Tuple[str, tuple], P]]
                 = None, batch_axes: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.rules = logical_rules(mesh)
        self.splits = splits
        self.batch_axes = tuple(batch_axes)

    def spec(self, name: str) -> P:
        return self.rules[name]

    def split_of(self, name: Optional[str], t) -> Optional[P]:
        """The spec of leaf ``name`` when this rank stores ``t`` split,
        else None (no training context, a replicated leaf, a plan)."""
        if self.splits is None or name is None or not hasattr(t, "shape"):
            return None
        return self.splits.get((name, tuple(t.shape)))


def current_context() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def mesh_axis_size(axis: str) -> int:
    ctx = current_context()
    if ctx is None or axis not in ctx.mesh.axis_names:
        return 1
    return ctx.mesh.shape[axis]


def split_dims(mesh, spec: P) -> List[Tuple[int, object]]:
    """(dimension, axes) of every dimension ``spec`` splits over more than
    one rank of ``mesh``."""
    return [(d, axes) for d, axes in enumerate(spec)
            if axes is not None and mesh.size(axes) > 1]


def param_spec_for_path(path: str, rules: Dict[str, P]) -> P:
    """Map a parameter tree path to a PartitionSpec by naming convention.

    Names ending in '_vd' -> vocab/embedding table, '_dh' -> col-parallel
    matmul, '_hd' -> row-parallel matmul, '_edf'/'_efd' -> expert stacks,
    '_bh' -> col-parallel bias, everything else -> replicated. A leading
    layer-stack dimension (the reference's 's_' prefix) shifts specs
    right."""
    leaf = path.split("/")[-1]
    stacked = leaf.startswith("s_")
    if stacked:
        leaf = leaf[2:]
    for suffix, key in (("_vd", "emb_vd"), ("_dh", "w_dh"), ("_hd", "w_hd"),
                        ("_edf", "moe_edf"), ("_efd", "moe_efd"),
                        ("_bh", "bias_h")):
        if leaf.endswith(suffix):
            spec = rules[key]
            if stacked:
                return P(*((None,) + tuple(spec)))
            return spec
    if stacked:
        return P(None)
    return P()
