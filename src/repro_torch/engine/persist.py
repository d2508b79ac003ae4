"""Plan persistence (counterpart of ``repro/engine/persist.py``):
programmed plans saved once and restored on boot, so a serving restart
skips re-programming (quantize + nibble-decompose + pad):

  engine.save_plans(dir, plans)            # after plan_params_for_pim
  plans, step, extras = engine.load_plans(dir)

Rides on :mod:`repro_torch.checkpoint.ckpt` (atomic publish, ``LATEST``
pointer, per-leaf sha256). The directory is byte-compatible with the JAX
package's: for the same plans both packages write a ``manifest.json``
equal as JSON (the plan spec in ``extras["engine_plans"]``, the
structure fingerprint, dtypes, shapes, digests) and equal ``arrays.npz``
members, and each loads the other's directory.

Layout. The JAX package holds each layer-stacked projection as one
vmapped plan (array fields with a leading layer axis), and its expert
stacks as one ``ExpertStackedPlan`` with (L, E, ...) fields. The port
holds a list of per-layer plans there (``lm.stack_layers``). So a list
of plans of one class and one geometry is saved as that one vmapped
plan: each field stacked on the host, one leaf at a time. Restoring such
a leaf moves it to the device once and splits it back into per-layer
views, which gives ``plan_params_for_pim``'s form. Plans elsewhere (a
CNN's ``{layer name: DensePlan | DepthwisePlan}``) map one to one.

Leaf order and paths are JAX's: dict keys sorted, sequences in order, a
plan's array children in its pytree order (``DensePlan``: values, scale,
planes, padded_scale, then the ABFT checksum record when the plan has
one, a dict child keyed ``i:4`` whose leaves come in sorted key order:
col_f32, col_i32, scale_sum; ``DepthwisePlan``: values, scale, planes;
``ExpertStackedPlan``: its ``dense`` plan), keyed as JAX renders a
registered node's children (``i:0``, ``i:1``, ...).

Each plan's ``PimConfig`` is written with the JAX package's field set and
substrate names (``exact-cuda`` -> ``exact-pallas``, ``exact-torch`` ->
``exact-jnp``, ``analog-cuda`` -> ``analog-pallas``) and read back the
way :func:`repro_torch.convert.config_from_reference` maps them.

Meshes (:mod:`repro_torch.engine.mesh`). A plan split over a mesh is
described with its whole (global) leaves and the JAX package's ``"shard":
{"kind", "axis"}`` stamp. Saving a stamped tree gathers each split leaf
from the ranks along its axis, one leaf at a time; the process of global
rank 0 writes the directory and the others wait at a barrier.
``load_plans(mesh=)`` re-places the restored tree: each rank keeps its
slice of the stamped plans and all of everything else. Without ``mesh=``
the stamps are dropped, with the JAX package's warning, and the plans
restore whole.
"""
from __future__ import annotations

import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.convert import config_from_reference
from repro_torch.core import pim
from repro_torch.engine import mesh as mesh_mod
from repro_torch.kernels.runtime import resolve_device

PLANS_EXTRAS_KEY = "engine_plans"
# leaves read back and hashed ahead of the one moved to the device
READ_AHEAD = 4

# the JAX package's names of the port's substrates, as its specs record
_JAX_SUBSTRATE = {port: jax for jax, port in pim.SUBSTRATE_ALIASES.items()}
# array children of each plan class, in its pytree order
_DENSE_FIELDS = ("values", "scale", "planes", "padded_scale")
_DEPTHWISE_FIELDS = ("values", "scale", "planes")
# the dense plan's child slot of its ABFT record (a dict subtree)
_ABFT_SLOT = len(_DENSE_FIELDS)


class PlanCorruptionError(ckpt.CheckpointCorruptionError):
    """A persisted plan leaf failed its manifest sha256 on restore (or
    could not be read back). ``leaf_path`` names the offending leaf in
    the plan tree (e.g. ``layers/attn/wq_dh.2``)."""

    def __init__(self, msg: str, leaf_path: str,
                 leaf_index: Optional[int] = None) -> None:
        super().__init__(msg, leaf_index=leaf_index)
        self.leaf_path = leaf_path


# ---------------------------------------------------------------------------
# spec: JSON description of a plan tree (structure + dtypes, no data)
# ---------------------------------------------------------------------------
def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _leaf_spec(shape, dtype: torch.dtype) -> Dict[str, Any]:
    return {"shape": [int(d) for d in shape], "dtype": _dtype_name(dtype)}


def _cfg_spec(cfg: pim.PimConfig) -> Dict[str, Any]:
    """The JAX package's ``dataclasses.asdict(PimConfig)``, in its field
    order, with its substrate names."""
    return {"weight_bits": cfg.weight_bits, "act_bits": cfg.act_bits,
            "cell_bits": cfg.cell_bits, "adc_bits": cfg.adc_bits,
            "wdm_chunk": cfg.wdm_chunk,
            "substrate": _JAX_SUBSTRATE.get(cfg.substrate, cfg.substrate),
            "analog": False, "read_noise_sigma": cfg.read_noise_sigma,
            "use_pallas": True, "interpret": None, "verify": cfg.verify,
            "abft_tag": cfg.abft_tag}


def _plan_stack(tree: Any) -> Optional[List[pim.Plan]]:
    """The plans of a list that stands for one layer-stacked plan (every
    entry a plan of one class), else None."""
    if not isinstance(tree, list) or not tree or \
            not isinstance(tree[0], pim.Plan):
        return None
    if any(type(p) is not type(tree[0]) for p in tree):
        raise TypeError("a list of plans must hold plans of one class "
                        "(the port's form of a layer-stacked plan)")
    return tree


def _fields(plan: pim.Plan) -> Tuple[str, ...]:
    return _DEPTHWISE_FIELDS if isinstance(plan, pim.DepthwisePlan) \
        else _DENSE_FIELDS


def _abft_record(plan: pim.Plan) -> Dict[str, torch.Tensor]:
    """A plan's ABFT checksum record in its flatten order (sorted keys),
    empty without one."""
    record = getattr(plan, "abft", None) or {}
    return {name: record[name] for name in sorted(record)}


def _geometry(plan: pim.Plan):
    """What a layer stack's plans must share: everything but the data."""
    dense = getattr(plan, "dense", plan)
    record = _abft_record(dense)
    shard = getattr(plan, "shard", None)
    return (type(plan), getattr(plan, "num_experts", None),
            None if shard is None else (shard.kind, shard.axis), dense.bits,
            getattr(dense, "k", None), getattr(dense, "n", None), dense.cfg,
            tuple(tuple(getattr(dense, f).shape) for f in _fields(dense)),
            tuple(getattr(dense, f).dtype for f in _fields(dense)),
            tuple((name, tuple(t.shape), t.dtype)
                  for name, t in record.items()))


def _stamp(shard) -> Dict[str, str]:
    return {"kind": shard.kind, "axis": shard.axis}


def _describe_plans(plans: List[pim.Plan], stacked: bool,
                    shard=None) -> Dict[str, Any]:
    """Spec of one plan (``stacked=False``) or of a layer stack (its
    fields get a leading axis of ``len(plans)``), with the whole leaves'
    shapes of a plan split over a mesh (``shard``: an expert stack's, for
    its dense plan)."""
    head = plans[0]
    if stacked and any(_geometry(p) != _geometry(head) for p in plans[1:]):
        raise ValueError("the plans of a layer stack must share their "
                         "geometry (class, bits, k, n, cfg, shapes, shard)")
    lead = [len(plans)] if stacked else []
    if isinstance(head, pim.ExpertStackedPlan):
        out = {"kind": "expert-plan", "num_experts": head.num_experts,
               "dense": _describe_plans([p.dense for p in plans], stacked,
                                        head.shard)}
        if head.shard is not None:
            out["shard"] = _stamp(head.shard)
        return out
    if isinstance(head, pim.DensePlan):
        shard = shard or head.shard
    leaves = [_leaf_spec(lead + list(mesh_mod.global_shape(head, shard, f)),
                         getattr(head, f).dtype) for f in _fields(head)]
    if isinstance(head, pim.DensePlan):
        out = {"kind": "dense-plan", "bits": head.bits, "k": head.k,
               "n": head.n, "cfg": _cfg_spec(head.cfg), "leaves": leaves}
        record = _abft_record(head)
        if record:
            # the ABFT checksum record, described key by key
            out["abft"] = {name: _leaf_spec(lead + list(t.shape), t.dtype)
                           for name, t in record.items()}
        if head.shard is not None:
            out["shard"] = _stamp(head.shard)
        return out
    if isinstance(head, pim.DepthwisePlan):
        return {"kind": "depthwise-plan", "bits": head.bits,
                "cfg": _cfg_spec(head.cfg), "leaves": leaves}
    raise TypeError(f"unknown plan class {type(head).__name__}")


def describe_plan_tree(tree: Any) -> Dict[str, Any]:
    """Recursively describe a tree of plans/tensors as a JSON-able spec,
    the JAX package's for the same plans (a list of per-layer plans is
    described as the one vmapped plan it stands for)."""
    if isinstance(tree, pim.Plan):
        return _describe_plans([tree], stacked=False)
    stack = _plan_stack(tree)
    if stack is not None:
        return _describe_plans(stack, stacked=True)
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": {str(k): describe_plan_tree(v)
                          for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "list" if isinstance(tree, list) else "tuple",
                "items": [describe_plan_tree(v) for v in tree]}
    if torch.is_tensor(tree):
        return {"kind": "leaf", **_leaf_spec(tree.shape, tree.dtype)}
    raise TypeError(f"save_plans cannot describe {type(tree).__name__}; "
                    "supported: dict/list/tuple of tensors and plans")


def _shard_stamps(spec: Dict[str, Any], path: str = "") -> list:
    """Collect (path, shard) pairs recorded in a plan-tree spec: the
    stamps a restore without ``mesh=`` drops."""
    kind = spec.get("kind")
    out = []
    if kind in ("dense-plan", "expert-plan") and spec.get("shard"):
        out.append((path or "<root>", spec["shard"]))
    if kind == "dict":
        for k, v in spec["items"].items():
            out += _shard_stamps(v, f"{path}/{k}" if path else k)
    elif kind in ("list", "tuple"):
        for i, v in enumerate(spec["items"]):
            out += _shard_stamps(v, f"{path}[{i}]")
    elif kind == "expert-plan":
        out += _shard_stamps(spec["dense"], f"{path}.dense")
    return out


# ---------------------------------------------------------------------------
# leaf paths in JAX's flatten order (spec-driven)
# ---------------------------------------------------------------------------
def _spec_paths(spec: Dict[str, Any], path: tuple = ()) -> List[tuple]:
    """Every array leaf's key path, in JAX's flatten order: ``("d", key)``
    for a dict key, ``("s", i)`` for a sequence index, ``("i", i)`` for a
    plan's child slot."""
    kind = spec["kind"]
    if kind == "dict":
        return [p for k in sorted(spec["items"])
                for p in _spec_paths(spec["items"][k], path + (("d", k),))]
    if kind in ("list", "tuple"):
        return [p for i, v in enumerate(spec["items"])
                for p in _spec_paths(v, path + (("s", i),))]
    if kind == "expert-plan":
        return _spec_paths(spec["dense"], path + (("i", 0),))
    if kind in ("dense-plan", "depthwise-plan"):
        return [path + (("i", i),) for i in range(len(spec["leaves"]))] + [
            path + (("i", _ABFT_SLOT), ("d", name))
            for name in sorted(spec.get("abft") or {})]
    if kind == "leaf":
        return [path]
    raise ValueError(f"unknown plan-spec kind {kind!r}")


def _fingerprint(spec: Dict[str, Any]) -> str:
    """``ckpt.tree_fingerprint`` of the tree ``spec`` describes, as the
    JAX package computes it (``d:'key'``, ``s:0``, ``i:0`` per key)."""
    import hashlib
    rendered = "\n".join("/".join(f"{kind}:{key!r}" for kind, key in p)
                         for p in _spec_paths(spec))
    return hashlib.sha256(rendered.encode()).hexdigest()[:16]


def _path_name(paths: List[tuple], index: Optional[int]) -> str:
    if index is None:
        return "<unknown leaf>"
    if not 0 <= index < len(paths):
        return f"<leaf {index}>"
    return "".join(f".{key}" if kind == "i" else f"/{key}"
                   for kind, key in paths[index]).lstrip("/.") or "<root>"


def _leaf_path_name(template: Any, index: Optional[int]) -> str:
    """Human name of flattened leaf ``index`` in a plan tree (container
    keys slash-joined, plan child slots dot-joined), as the JAX package
    names the same leaf, e.g. ``layers/attn/wq_dh.2``."""
    return _path_name(_spec_paths(describe_plan_tree(template)), index)


# ---------------------------------------------------------------------------
# template
# ---------------------------------------------------------------------------
def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


def _zeros(leaf: Dict[str, Any], device) -> torch.Tensor:
    return torch.zeros(tuple(leaf["shape"]), dtype=_torch_dtype(leaf["dtype"]),
                       device=device)


def _plans_from_spec(spec: Dict[str, Any], take, lead: int) -> Any:
    """The plan(s) of a plan spec from its leaves (``take(leaf spec)``
    gives the next tensor): one plan, or, when its fields carry ``lead``
    extra leading axes (1: a layer stack), the list of per-layer plans as
    views of the stacked tensors."""
    if spec["kind"] == "expert-plan":
        dense = _plans_from_spec(spec["dense"], take, lead)
        wrap = lambda d: pim.ExpertStackedPlan(
            dense=d, num_experts=spec["num_experts"])
        return [wrap(d) for d in dense] if lead else wrap(dense)
    cfg = config_from_reference(spec["cfg"])
    names = sorted(spec.get("abft") or {})
    tensors = [take(leaf) for leaf in spec["leaves"]]
    tensors += [take(spec["abft"][name]) for name in names]
    nf = len(spec["leaves"])
    if spec["kind"] == "dense-plan":
        build = lambda f: pim.DensePlan(
            values=f[0], scale=f[1], planes=f[2], padded_scale=f[3],
            bits=spec["bits"], k=spec["k"], n=spec["n"], cfg=cfg,
            abft=dict(zip(names, f[nf:])) if names else None)
    else:
        build = lambda f: pim.DepthwisePlan(
            values=f[0], scale=f[1], planes=f[2], bits=spec["bits"],
            cfg=cfg)
    if not lead:
        return build(tensors)
    per_layer = [torch.unbind(t) for t in tensors]
    return [build([fields[i] for fields in per_layer])
            for i in range(len(per_layer[0]))]


def _plan_rank(spec: Dict[str, Any]) -> int:
    """A plan's own ``values`` rank: 2, or 3 for an expert stack."""
    return 3 if spec["kind"] == "expert-plan" else 2


def _values_rank(spec: Dict[str, Any]) -> int:
    dense = spec["dense"] if spec["kind"] == "expert-plan" else spec
    return len(dense["leaves"][0]["shape"])


def _rebuild(spec: Dict[str, Any], take, place=None) -> Any:
    """The port's tree ``spec`` describes, its leaves taken in JAX's
    flatten order (dict items in sorted key order, built in the spec's
    own order). ``place(plan, stamp)``, if given, maps each plan as soon
    as it is built (``stamp``: the spec's shard record or None)."""
    kind = spec["kind"]
    if kind == "dict":
        built = {k: _rebuild(spec["items"][k], take, place)
                 for k in sorted(spec["items"])}
        return {k: built[k] for k in spec["items"]}
    if kind in ("list", "tuple"):
        items = [_rebuild(v, take, place) for v in spec["items"]]
        return items if kind == "list" else tuple(items)
    if kind in ("dense-plan", "depthwise-plan", "expert-plan"):
        lead = _values_rank(spec) - _plan_rank(spec)
        if lead not in (0, 1):
            raise ValueError(f"plan spec with {lead} leading axes; the port "
                             "takes unstacked or layer-stacked plans")
        plans = _plans_from_spec(spec, take, lead)
        if place is None:
            return plans
        stamp = spec.get("shard")
        return [place(p, stamp) for p in plans] if lead \
            else place(plans, stamp)
    if kind == "leaf":
        return take(spec)
    raise ValueError(f"unknown plan-spec kind {kind!r}")


def build_plan_template(spec: Dict[str, Any], device="meta") -> Any:
    """Rebuild a template tree from a plan-tree spec: zero-filled tensors
    on ``device``, or, on the default ``"meta"``, shapes and dtypes
    without memory. A layer-stacked plan comes back as the list of its
    per-layer plans."""
    return _rebuild(spec, lambda leaf: _zeros(leaf, device))


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def _tensor_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # npz has no bf16: store raw bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stacked_array(tensors: List[torch.Tensor]) -> np.ndarray:
    """One field of a layer stack, stacked on the host."""
    first = _tensor_array(tensors[0])
    out = np.empty((len(tensors),) + first.shape, first.dtype)
    out[0] = first
    for i, t in enumerate(tensors[1:], 1):
        out[i] = _tensor_array(t)
    return out


def _producers(tree: Any) -> List[Tuple[Any, bool]]:
    """Zero-argument producers of every stored leaf, in JAX's flatten
    order, each with whether it is collective (it gathers a leaf split
    over a mesh: every rank on the split's axis must call it, in this
    order). A producer returns (array, dtype name) when called."""
    def leaf(make, dtype):
        return lambda: (make(), _dtype_name(dtype))

    def plan_leaves(plans: List[pim.Plan], stacked: bool,
                    shard=None) -> List:
        head = plans[0]
        if isinstance(head, pim.ExpertStackedPlan):
            return plan_leaves([p.dense for p in plans], stacked, head.shard)
        shard = shard or getattr(head, "shard", None)
        names = list(_fields(head)) + list(_abft_record(head))
        per_plan = [[getattr(p, f) for f in _fields(head)]
                    + list(_abft_record(p).values()) for p in plans]
        out = []
        for name, fields in zip(names, zip(*per_plan)):
            def make(fields=fields, name=name):
                whole = [mesh_mod.gather_leaf(t, shard, name) for t in fields]
                return _stacked_array(whole) if stacked \
                    else _tensor_array(whole[0])
            out.append((leaf(make, fields[0].dtype), shard is not None))
        return out

    if isinstance(tree, pim.Plan):
        return plan_leaves([tree], stacked=False)
    stack = _plan_stack(tree)
    if stack is not None:
        return plan_leaves(stack, stacked=True)
    if isinstance(tree, dict):
        return [p for k in sorted(tree, key=str) for p in _producers(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _producers(v)]
    return [(leaf(lambda t=tree: _tensor_array(t), tree.dtype), False)]


def save_plans(directory: str, plans: Any, step: int = 0,
               extras: Optional[Dict[str, Any]] = None) -> str:
    """Persist a tree of programmed plans (and interleaved tensors).

    Every plan's substrate and full ``PimConfig`` land in the manifest
    ``extras`` (under :data:`PLANS_EXTRAS_KEY`), so a restart can rebuild
    the tree and audit what it was programmed for. Leaves are gathered to
    the host one at a time. Returns the published checkpoint path.

    In a process group of more than one rank, every rank calls this with
    its own (possibly mesh-split) tree: the split leaves are gathered
    leaf by leaf, the process of global rank 0 writes the directory, and
    every rank returns once rank 0 has told them how the write went; a
    failed write raises on every rank (:func:`~repro_torch.checkpoint.
    ckpt.write_on_rank0`)."""
    all_extras = dict(extras or {})
    spec = describe_plan_tree(plans)
    all_extras[PLANS_EXTRAS_KEY] = spec
    return ckpt.write_on_rank0(directory, step, _fingerprint(spec),
                               _producers(plans), all_extras)


def load_plans(directory: str, step: Optional[int] = None, *, mesh=None,
               device=None) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore a plan tree saved by :func:`save_plans` (or by the JAX
    package's) onto ``device`` (``None``: the mesh's device, else CUDA).
    With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`), each plan
    saved with a shard stamp is split again as it is restored, each rank
    keeping its slice, and everything else restores whole on every rank;
    without it the stamps are dropped with a warning.

    Returns ``(plans, step, extras)`` with :data:`PLANS_EXTRAS_KEY`
    stripped from ``extras``. Each stored leaf is checked against its
    sha256 and moved to the device once; a layer-stacked plan comes back
    as per-layer views. Raises FileNotFoundError when no checkpoint
    exists, ValueError when the checkpoint was not written by
    ``save_plans`` or its structure does not match its spec, and
    :class:`PlanCorruptionError` naming the leaf when a leaf fails its
    digest or cannot be read."""
    device = mesh.device if mesh is not None and device is None \
        else resolve_device(device)
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no plan checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    spec = manifest.get("extras", {}).get(PLANS_EXTRAS_KEY)
    if spec is None:
        raise ValueError(
            f"checkpoint at {directory} step {step} has no "
            f"{PLANS_EXTRAS_KEY!r} spec: was it written by save_plans?")
    paths = _spec_paths(spec)
    if len(paths) != manifest["num_leaves"]:
        raise ValueError(f"leaf count mismatch: ckpt "
                         f"{manifest['num_leaves']} vs spec {len(paths)}")
    saved_fp = manifest.get("treedef")
    if saved_fp is not None and saved_fp != _fingerprint(spec):
        raise ValueError(
            f"checkpoint tree structure mismatch at {path}: saved "
            f"fingerprint {saved_fp} != spec {_fingerprint(spec)}")
    npz = os.path.join(path, "arrays.npz")
    digests = manifest.get("sha256")

    def read(i: int):
        """Leaf ``i`` read back (on a reader thread, with a handle of its
        own) and the sha256 of its stored bytes; the exception if it
        cannot be read."""
        try:
            with np.load(npz) as data:
                arr = data[f"leaf_{i:05d}"]
        except Exception as e:  # truncated/torn npz member
            return None, e
        return arr, (ckpt.payload_sha256(arr) if digests is not None
                     else None)

    # leaves are read and hashed READ_AHEAD at a time on reader threads
    # while the caller's thread moves the earlier ones to the device
    pool = ThreadPoolExecutor(max_workers=READ_AHEAD)
    pending = {i: pool.submit(read, i)
               for i in range(min(READ_AHEAD, len(paths)))}
    index = iter(range(len(paths)))

    def take(leaf: Dict[str, Any]) -> torch.Tensor:
        i = next(index)
        if i + READ_AHEAD < len(paths):
            pending[i + READ_AHEAD] = pool.submit(read, i + READ_AHEAD)
        arr, live = pending.pop(i).result()
        name = f"leaf_{i:05d}"
        where = _path_name(paths, i)
        if arr is None:
            raise PlanCorruptionError(
                f"plan checkpoint at {directory} step {step} is corrupt: "
                f"leaf {where!r} ({name}): cannot read it: {live}",
                leaf_path=where, leaf_index=i) from live
        if digests is not None and live != digests[i]:
            raise PlanCorruptionError(
                f"plan checkpoint at {directory} step {step} is "
                f"corrupt: leaf {where!r} ({name}): payload sha256 "
                f"mismatch: stored {digests[i][:12]}..., read "
                f"{live[:12]}...", leaf_path=where, leaf_index=i)
        if list(arr.shape) != list(leaf["shape"]):
            raise ValueError(f"shape mismatch at leaf {i} ({where}): "
                             f"{arr.shape} vs {leaf['shape']}")
        t = ckpt.to_tensor(arr, manifest["dtypes"][i], device)
        del arr
        return t.to(dtype=_torch_dtype(leaf["dtype"]))

    def place(plan, stamp):
        if stamp is None:
            return plan
        return mesh_mod.shard_plan(plan, mesh, stamp["kind"],
                                   axis=stamp["axis"])

    try:
        plans = _rebuild(spec, take, None if mesh is None else place)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    stamps = _shard_stamps(spec) if mesh is None else []
    if stamps:
        head = ", ".join(
            f"{p}:{s['kind']}@axis{s['axis']}" for p, s in stamps[:3])
        more = f", +{len(stamps) - 3} more" if len(stamps) > 3 else ""
        warnings.warn(
            f"load_plans(mesh=None) drops {len(stamps)} saved shard "
            f"stamp(s) ({head}{more}); plans restore replicated; "
            "pass mesh= to re-place them", UserWarning, stacklevel=2)
    extras = {k: v for k, v in manifest["extras"].items()
              if k != PLANS_EXTRAS_KEY}
    return plans, step, extras


__all__ = ["PLANS_EXTRAS_KEY", "PlanCorruptionError", "build_plan_template",
           "describe_plan_tree", "load_plans", "save_plans"]
