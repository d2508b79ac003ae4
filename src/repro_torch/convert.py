"""Convert the JAX package's parameters and plans into the port's.

Everything crosses as numpy arrays (``np.asarray`` of any array-like), so
this module imports neither JAX nor the JAX package: it reads the same
field names from duck-typed objects. bfloat16 leaves (numpy dtype named
``bfloat16``) are read as their raw uint16 bits and reinterpreted, never
rounded through float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim.adamw import AdamWState

# PimConfig fields of the reference that the port has no counterpart for:
# the Pallas interpret flag and the deprecated boolean route aliases
_DROPPED_CFG_FIELDS = ("interpret", "analog", "use_pallas")


def tensor_from_numpy(x: Any, device=None) -> torch.Tensor:
    """One array leaf -> a torch tensor on ``device`` (``None`` -> CUDA)."""
    arr = np.array(x, order="C")     # a copy; keeps 0-d arrays 0-d
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_reference(tree: Any, device=None) -> Any:
    """A nested dict / list / tuple of array leaves (e.g. the reference's
    ``init_cnn`` params, or its ``init_lm`` params with the layers stacked
    along a leading axis, which the port keeps) -> the same structure of
    torch tensors."""
    if isinstance(tree, Mapping):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def config_from_reference(cfg: Any) -> pim.PimConfig:
    """The reference's ``PimConfig`` (an object or a mapping of its
    fields) -> the port's. The deprecated boolean route pair resolves the
    way the reference resolves it; JAX substrate names map to their
    counterparts through the engine's aliases."""
    fields = dict(cfg) if isinstance(cfg, Mapping) else {
        f: getattr(cfg, f) for f in _field_names(cfg)}
    substrate = fields.get("substrate")
    if substrate is None:
        if fields.get("analog", False):
            substrate = "analog"
        elif not fields.get("use_pallas", True):
            substrate = pim.EXACT_TORCH
    for name in _DROPPED_CFG_FIELDS:
        fields.pop(name, None)
    fields["substrate"] = None if substrate is None else \
        pim.SUBSTRATE_ALIASES.get(substrate, substrate)
    known = {f.name for f in pim.PimConfig.__dataclass_fields__.values()}
    return pim.PimConfig(**{k: v for k, v in fields.items() if k in known})


def _field_names(obj: Any):
    dc_fields = getattr(obj, "__dataclass_fields__", None)
    if dc_fields is None:
        raise TypeError(f"cannot read PimConfig fields from {type(obj)}")
    return list(dc_fields)


def _abft_from_reference(abft: Any, device) -> Any:
    """A reference plan's ABFT checksum record (``None`` or a mapping of
    arrays) with the arrays unchanged."""
    if abft is None:
        return None
    return {name: tensor_from_numpy(v, device) for name, v in abft.items()}


def plan_from_reference(plan: Any, device=None) -> pim.Plan:
    """A reference ``DensePlan``, ``DepthwisePlan`` or
    ``ExpertStackedPlan`` (or a mapping of its fields) -> the port's plan
    of the same kind, fields (and the ABFT checksum record) unchanged."""
    get = plan.get if isinstance(plan, Mapping) else \
        (lambda name, default=None: getattr(plan, name, default))
    if get("dense") is not None:
        return pim.ExpertStackedPlan(
            dense=plan_from_reference(get("dense"), device),
            num_experts=int(get("num_experts")))
    cfg = config_from_reference(get("cfg"))
    values = tensor_from_numpy(get("values"), device)
    scale = tensor_from_numpy(get("scale"), device)
    planes = tensor_from_numpy(get("planes"), device)
    if get("padded_scale") is not None:
        return pim.DensePlan(
            values=values, scale=scale, planes=planes,
            padded_scale=tensor_from_numpy(get("padded_scale"), device),
            bits=int(get("bits")), k=int(get("k")), n=int(get("n")), cfg=cfg,
            abft=_abft_from_reference(get("abft"), device))
    return pim.DepthwisePlan(values=values, scale=scale, planes=planes,
                             bits=int(get("bits")), cfg=cfg)


def plans_from_reference(plans: Mapping[str, Any], device=None
                         ) -> Dict[str, pim.Plan]:
    """A ``{layer name: plan}`` dict (e.g. the reference's
    ``plan_cnn_weights`` output) -> the port's plans."""
    return {name: plan_from_reference(p, device)
            for name, p in plans.items()}


_PLAN_ARRAYS = ("values", "scale", "planes", "padded_scale")


def _layer_plan(dense: Any, i: int, arrays: Dict[str, np.ndarray],
                record: Any) -> dict:
    """Layer ``i``'s fields (and checksum record) of a vmapped reference
    ``DensePlan``."""
    return dict({f: arrays[f][i] for f in _PLAN_ARRAYS}, bits=dense.bits,
                k=dense.k, n=dense.n, cfg=dense.cfg,
                abft=None if record is None else
                {name: v[i] for name, v in record.items()})


def planned_params_from_reference(tree: Any, device=None) -> Any:
    """The reference's ``plan_params_for_pim`` tree -> the port's.

    There, each planned projection is one vmapped ``DensePlan`` whose
    array fields carry a leading layer axis while ``bits``, ``k``, ``n``
    and ``cfg`` are shared pytree aux data, and each expert stack one
    ``ExpertStackedPlan`` whose ``dense`` fields carry (L, E, ...) axes;
    here each becomes a list of per-layer plans (what
    ``repro_torch.launch.serve.plan_params_for_pim`` builds). Every other
    leaf converts as in :func:`params_from_reference`."""
    if isinstance(tree, Mapping):
        return {k: planned_params_from_reference(v, device)
                for k, v in tree.items()}
    dense = getattr(tree, "dense", None)
    if dense is not None or hasattr(tree, "planes"):   # a (vmapped) plan
        source = tree if dense is None else dense
        arrays = {f: np.asarray(getattr(source, f)) for f in _PLAN_ARRAYS}
        record = getattr(source, "abft", None)
        if record is not None:
            record = {name: np.asarray(v) for name, v in record.items()}
        layers = [_layer_plan(source, i, arrays, record)
                  for i in range(arrays["values"].shape[0])]
        if dense is not None:
            layers = [{"dense": d, "num_experts": tree.num_experts}
                      for d in layers]
        return [plan_from_reference(p, device) for p in layers]
    return tensor_from_numpy(tree, device)


def model_config_from_reference(cfg: Any) -> ModelConfig:
    """The reference's ``ModelConfig`` -> the port's (the same fields)."""
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def train_state_from_reference(state: Mapping[str, Any], device=None
                               ) -> Dict[str, Any]:
    """The reference's training state ``{"params", "opt": AdamWState,
    "step"[, "grad_err"]}`` (arrays, or numpy) -> the port's, the same
    structure with ``repro_torch.optim.adamw.AdamWState``."""
    opt = state["opt"]
    out = {"params": params_from_reference(state["params"], device),
           "opt": AdamWState(step=tensor_from_numpy(opt.step, device),
                             mu=params_from_reference(opt.mu, device),
                             nu=params_from_reference(opt.nu, device)),
           "step": tensor_from_numpy(state["step"], device)}
    if state.get("grad_err") is not None:
        out["grad_err"] = params_from_reference(state["grad_err"], device)
    return out
