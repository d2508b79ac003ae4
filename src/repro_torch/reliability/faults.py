"""Deterministic fault injection into programmed PIM plans (counterpart of
``repro/reliability/faults.py``).

Models the silent-error modes of the optical datapath as mutations of a
*programmed* plan tree: faults land in the stationary stores, where
OPIMA's MRR/PCM arrays would take them.

  ``bitflips``        bit-flips in the stored int codes. Mutates
                      ``values`` and re-derives the nibble planes from
                      the corrupted codes (the device is re-programmed
                      from a corrupted code store).
  ``stuck_planes``    a stuck nibble plane: one base-16 digit plane of
                      one output column reads a constant. Device-store
                      fault: ``planes`` only; the code store keeps the
                      intended values.
  ``dropped_chunks``  a WDM chunk of ``cfg.wdm_chunk`` wavelengths goes
                      dark: that K-range of every plane reads zero.
  ``adc_gain`` /      multiplicative / additive drift on the per-column
  ``adc_offset``      dequantization scales (thermal ADC drift).

Injection is a pure function of ``(spec, plan path)``: every plan gets
its own ``np.random.default_rng`` seeded from the model seed and a sha256
of its tree path, and the draws run in the JAX package's order on host
copies of the stores, so the same spec corrupts the same entries bit for
bit in both packages and gives the same report. The plan's ABFT
checksum record, programmed before injection, is never touched: it is
the golden reference detection compares against.

Layer stacks. The JAX package holds each layer-stacked projection as one
vmapped plan (fields with a leading layer axis; expert stacks (L, E,
...)), tagged once with its path. The port holds a list of per-layer
plans there (``lm.stack_layers``). :func:`inject_tree` treats such a list
as that one stacked plan at the list's path: one generator, ``b``
ranging over the L layers (L * E experts, row-major) and one
``store_delta`` over the whole stack; no layer index enters a path.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pim
from repro_torch.quant import nibbles

_MAX_DIGIT = nibbles.NIBBLE_BASE - 1
_STORES = ("values", "planes", "scale", "padded_scale")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One injected fault pattern, targeted by a glob over plan paths."""

    target: str = "*"          # fnmatch glob over tree paths
    seed: int = 0
    bitflips: int = 0          # flips in stored codes (per matched plan)
    stuck_planes: int = 0      # stuck digit-plane/column pairs
    stuck_value: int = 0       # the value a stuck plane reads
    dropped_chunks: int = 0    # dark WDM chunks
    adc_gain: float = 1.0      # multiplicative scale drift
    adc_offset: float = 0.0    # additive scale drift
    sticky: bool = True        # survives re-programming (hard fault)

    @property
    def is_noop(self) -> bool:
        return (self.bitflips == 0 and self.stuck_planes == 0
                and self.dropped_chunks == 0 and self.adc_gain == 1.0
                and self.adc_offset == 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultModel":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault spec field(s) "
                             f"{sorted(unknown)}; known: {sorted(known)}")
        return cls(**d)


def load_fault_spec(path: str) -> List[FaultModel]:
    """Load a JSON fault spec: either a list of fault dicts or
    ``{"faults": [...]}`` (the ``serve --inject-faults`` format)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("faults", [])
    if not isinstance(data, list):
        raise ValueError(f"fault spec {path} must be a list of fault "
                         "objects or {'faults': [...]}")
    return [FaultModel.from_dict(d) for d in data]


def dump_fault_spec(models: Sequence[FaultModel]) -> str:
    return json.dumps({"faults": [m.to_dict() for m in models]}, indent=2)


def _rng_for(model: FaultModel, path: str) -> np.random.Generator:
    digest = hashlib.sha256(f"{model.seed}:{path}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def _plane_colsums(planes: np.ndarray) -> np.ndarray:
    """Recombined column sums of a (..., Pw, Kp, Np) plane store:
    sum_n sum_d 16^d * planes[..., d, k, n] -> (..., Kp) int64."""
    pw = planes.shape[-3]
    shifts = (nibbles.NIBBLE_BASE ** np.arange(pw)).astype(np.int64)
    per_plane = planes.sum(axis=-1, dtype=np.int64)        # (..., Pw, Kp)
    return np.einsum("p,...pk->...k", shifts, per_plane)


def _store_delta(planes: np.ndarray, col_i32: Optional[np.ndarray],
                 k: int) -> Optional[int]:
    """How many checksum-column entries the mutated store now disagrees
    with: the host-side detectability measure the chaos checks assert
    against (0 means the injected pattern cancelled out exactly); None
    for a plan without a checksum record."""
    if col_i32 is None:
        return None
    live = _plane_colsums(planes)                          # (..., Kp)
    expected = np.zeros(live.shape, np.int64)
    expected[..., :k] = np.asarray(col_i32, np.int64)
    return int(np.sum(live != expected))


# ---------------------------------------------------------------------------
# host copies of a plan's (or a layer stack's) stores
# ---------------------------------------------------------------------------
def _denses(plans: Sequence[pim.Plan]) -> List[pim.DensePlan]:
    return [getattr(p, "dense", p) for p in plans]


def _host_stack(tensors: Sequence[torch.Tensor], stacked: bool
                ) -> np.ndarray:
    """A writable host copy of one tensor, or of a list stacked on a new
    leading axis (filled one tensor at a time)."""
    if not stacked:
        return tensors[0].detach().to("cpu", copy=True).numpy()
    first = tensors[0].detach().cpu().numpy()
    out = np.empty((len(tensors),) + first.shape, first.dtype)
    for i, t in enumerate(tensors):
        out[i] = t.detach().cpu().numpy()
    return out


def _host_stores(plans: Sequence[pim.Plan], stacked: bool
                 ) -> Dict[str, Any]:
    dense = _denses(plans)
    stores = {f: _host_stack([getattr(d, f) for d in dense], stacked)
              for f in _STORES}
    stores["col_i32"] = None if dense[0].abft is None else _host_stack(
        [d.abft["col_i32"] for d in dense], stacked)
    return stores


def _inject_stores(stores: Dict[str, Any], plan: pim.DensePlan,
                   model: FaultModel, path: str) -> List[Dict[str, Any]]:
    """Apply ``model`` to the host stores of ``plan``'s geometry (leaves
    may carry leading layer/expert axes), in place, in the JAX package's
    draw order. Returns a report of every injected fault."""
    if model.is_noop:
        return []
    k, n = plan.k, plan.n
    values, planes = stores["values"], stores["planes"]
    lead = values.shape[:-2]
    b_count = int(np.prod(lead)) if lead else 1
    vals_r = values.reshape(b_count, k, n)
    pw, kp, np_ = planes.shape[-3:]
    planes_r = planes.reshape(b_count, pw, kp, np_)
    rng = _rng_for(model, path)
    report: List[Dict[str, Any]] = []

    def _reprogram(b: int) -> None:
        # the device is re-programmed from the (corrupted) code store:
        # re-derive the nibble planes so both stores stay coherent
        pl = nibbles.to_nibbles(torch.from_numpy(vals_r[b]),
                                plan.bits).numpy()
        planes_r[b] = np.pad(pl, ((0, 0), (0, kp - k), (0, np_ - n)))

    for _ in range(model.bitflips):
        b = int(rng.integers(b_count))
        ki = int(rng.integers(k))
        ni = int(rng.integers(n))
        bit = int(rng.integers(max(plan.bits - 1, 1)))
        code = int(vals_r[b, ki, ni])
        sign = -1 if code < 0 else (1 if code > 0
                                    else (1 if rng.integers(2) else -1))
        vals_r[b, ki, ni] = sign * (abs(code) ^ (1 << bit))
        _reprogram(b)
        report.append({"path": path, "kind": "bitflip",
                       "where": [b, ki, ni], "bit": bit})

    for _ in range(model.stuck_planes):
        b = int(rng.integers(b_count))
        d = int(rng.integers(pw))
        ni = int(rng.integers(n))
        v = int(np.clip(model.stuck_value, -_MAX_DIGIT, _MAX_DIGIT))
        planes_r[b, d, :, ni] = v
        report.append({"path": path, "kind": "stuck_plane",
                       "where": [b, d, ni], "value": v})

    chunk = max(int(plan.cfg.wdm_chunk), 1)
    n_chunks = max((kp + chunk - 1) // chunk, 1)
    for _ in range(model.dropped_chunks):
        b = int(rng.integers(b_count))
        c = int(rng.integers(n_chunks))
        planes_r[b, :, c * chunk:(c + 1) * chunk, :] = 0
        report.append({"path": path, "kind": "dropped_chunk",
                       "where": [b, c], "k_range": [c * chunk,
                                                    min((c + 1) * chunk, kp)]})

    if model.adc_gain != 1.0 or model.adc_offset != 0.0:
        stores["scale"] = stores["scale"] * model.adc_gain + model.adc_offset
        padded = stores["padded_scale"]
        padded[..., :n] = (padded[..., :n] * model.adc_gain
                           + model.adc_offset)
        report.append({"path": path, "kind": "adc_drift",
                       "gain": model.adc_gain, "offset": model.adc_offset})

    delta = _store_delta(planes, stores["col_i32"], k)
    for entry in report:
        entry["sticky"] = model.sticky
        if delta is not None:
            entry["store_delta"] = delta
    return report


def _plans_from_stores(plans: Sequence[pim.Plan], stores: Dict[str, Any],
                       stacked: bool) -> Any:
    """The plan (or the list of per-layer plans, views of one stacked
    tensor per store) with the mutated stores, on the plans' device; the
    checksum record is kept as it was."""
    dense = _denses(plans)
    dev = dense[0].values.device
    fields = {}
    for f in _STORES:
        t = torch.from_numpy(np.ascontiguousarray(stores[f])).to(
            device=dev, dtype=getattr(dense[0], f).dtype)
        fields[f] = torch.unbind(t) if stacked else [t]
    out = []
    for i, (plan, d) in enumerate(zip(plans, dense)):
        new = dataclasses.replace(d, **{f: fields[f][i] for f in _STORES})
        out.append(dataclasses.replace(plan, dense=new)
                   if isinstance(plan, pim.ExpertStackedPlan) else new)
    return out if stacked else out[0]


def _inject_plans(plans: Sequence[pim.Plan], models: Sequence[FaultModel],
                  path: str, stacked: bool) -> Tuple[Any, List[Dict]]:
    """Every model of ``models`` that is not a no-op, in order, on one
    host copy of the plans' stores (one round trip to the host)."""
    active = [m for m in models if not m.is_noop]
    if not active:
        return (list(plans) if stacked else plans[0]), []
    head = _denses(plans)[0]
    stores = _host_stores(plans, stacked)
    report: List[Dict[str, Any]] = []
    for model in active:
        report += _inject_stores(stores, head, model, path)
    return _plans_from_stores(plans, stores, stacked), report


def inject_dense(plan: pim.DensePlan, model: FaultModel, path: str
                 ) -> Tuple[pim.DensePlan, List[Dict[str, Any]]]:
    """Apply ``model`` to one dense plan (its fields may carry leading
    expert axes). Returns the mutated plan and a report of every
    injected fault."""
    return _inject_plans([plan], [model], path, stacked=False)


def _plan_stack(tree: Any) -> Optional[List[pim.Plan]]:
    """The plans of a list that stands for one layer-stacked plan (every
    entry a dense or expert-stacked plan of one class), else None."""
    if not isinstance(tree, list) or not tree or not all(
            type(p) is type(tree[0]) for p in tree) or not isinstance(
                tree[0], (pim.DensePlan, pim.ExpertStackedPlan)):
        return None
    return tree


def inject_tree(tree: Any, models: Sequence[FaultModel], *,
                sticky_only: bool = False, _path: str = ""
                ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Walk a params tree, applying every matching fault model to every
    dense plan (expert stacks and layer stacks included). Paths are
    slash-joined container keys, the same naming ``ReliabilityManager``
    uses for repairs and the fault spec's ``target`` globs match against.
    ``sticky_only`` restricts to hard faults (used when re-injecting
    after a repair)."""
    stack = _plan_stack(tree)
    if stack is not None or isinstance(tree, (pim.DensePlan,
                                              pim.ExpertStackedPlan)):
        matched = [m for m in models
                   if not (sticky_only and not m.sticky)
                   and fnmatch.fnmatchcase(_path, m.target)]
        if not matched:
            return tree, []
        plans = stack if stack is not None else [tree]
        return _inject_plans(plans, matched, _path,
                             stacked=stack is not None)
    if isinstance(tree, dict):
        out, report = {}, []
        for key, val in tree.items():
            sub = f"{_path}/{key}" if _path else str(key)
            out[key], rep = inject_tree(val, models,
                                        sticky_only=sticky_only, _path=sub)
            report += rep
        return out, report
    if isinstance(tree, (list, tuple)):
        items, report = [], []
        for i, val in enumerate(tree):
            sub = f"{_path}/{i}" if _path else str(i)
            item, rep = inject_tree(val, models,
                                    sticky_only=sticky_only, _path=sub)
            items.append(item)
            report += rep
        return (items if isinstance(tree, list) else tuple(items)), report
    # tensors, DepthwisePlan (no LM serving path), scalars: untouched
    return tree, []


def summarize(report: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    by_kind: Dict[str, int] = {}
    paths = set()
    for entry in report:
        by_kind[entry["kind"]] = by_kind.get(entry["kind"], 0) + 1
        paths.add(entry["path"])
    return {"total": len(report), "by_kind": by_kind,
            "plans": sorted(paths)}
