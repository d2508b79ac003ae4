"""Graceful-degradation state machine for the serving engine (counterpart
of ``repro/reliability/degrade.py``).

The :class:`ReliabilityManager` owns three versions of the model params:

  ``golden``    the pristine programmed plans (pre-injection): never
                served directly, kept as the repair source and the
                fallback substrate's weight store.
  ``params``    the live (possibly fault-injected) plans the engine
                serves from. Faults from the configured spec are
                injected here at construction, deterministically.
  ``fallback``  the golden plans re-stamped onto an exact, verify-off
                substrate. A dispatch retried on these params is
                bit-identical to a fault-free run of the exact datapath.

The fallback substrate defaults to ``exact-cuda``, where the JAX
package's default is ``exact-jnp``: on the card the plain version must
not run on a main path, and ``exact-cuda`` launches B1 there (its plain
version on CPU tensors, by the device rule). Both exact substrates give
the same bits, with or without the row-sums, so the replay equals a
fault-free primary run on either.

Per-dispatch flow (driven by the serving engine):

  1. dispatch on ``params`` (ABFT verification armed via ``cfg.verify``);
     the engine delivers the dispatch's per-tag counts to the fault log
  2. ``drain()``: credits the checks and drains the fault log
  3. violations?  -> ``record_violations`` (strike ledger), replay the
     same dispatch on ``fallback`` from the pre-dispatch state, then
     ``maybe_repair()``: re-program the offending plans from golden
     (sticky faults re-inject themselves: hard faults survive
     re-programming), and after ``degrade_after`` repairs of the same
     plan give up and pin the engine to the fallback substrate
     (degraded-but-correct mode).

The fallback substrate is verify-off, so a faulty substrate can never
hang the serving loop: the worst case is one extra exact dispatch per
step plus a bounded number of re-programmings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import pim
from repro_torch.reliability import abft
from repro_torch.reliability.faults import FaultModel, inject_tree

_EXACT_FALLBACKS = (pim.EXACT_CUDA, pim.EXACT_TORCH)


@dataclasses.dataclass(frozen=True)
class ReliabilityPolicy:
    """Knobs of the degradation state machine. What is checked is each
    plan's own ``cfg.verify``, stamped at programming, and a dispatch that
    trips is replayed once: the JAX package's ``verify`` and
    ``max_retries`` fields, which nothing there reads, are not ported."""

    repair_after: int = 1           # strikes before a plan is re-programmed
    degrade_after: int = 3          # repairs of one plan before degrading
    fallback_substrate: str = pim.EXACT_CUDA   # JAX names accepted

    def __post_init__(self) -> None:
        if pim.SUBSTRATE_ALIASES.get(self.fallback_substrate,
                                     self.fallback_substrate) \
                not in _EXACT_FALLBACKS:
            raise ValueError(
                "fallback must be an exact substrate (retried completions "
                f"are promised bit-identical), got {self.fallback_substrate!r}")


def retarget_plans(tree: Any, substrate: str, verify: str = "off") -> Any:
    """Re-stamp every plan in a params tree onto ``substrate`` with the
    given verify policy (structure-preserving; the tensors are shared)."""
    def _cfg(cfg: pim.PimConfig) -> pim.PimConfig:
        return dataclasses.replace(cfg, substrate=substrate, verify=verify)

    def _walk(node: Any) -> Any:
        if isinstance(node, pim.ExpertStackedPlan):
            return dataclasses.replace(node, dense=_walk(node.dense))
        if isinstance(node, (pim.DensePlan, pim.DepthwisePlan)):
            return dataclasses.replace(node, cfg=_cfg(node.cfg))
        if isinstance(node, dict):
            return {k: _walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [_walk(v) for v in node]
            return items if isinstance(node, list) else tuple(items)
        return node

    return _walk(tree)


def armed_tags(tree: Any) -> List[str]:
    """ABFT tags of every verified plan in a params tree: the checks a
    clean dispatch runs without posting a violation."""
    tags = set()

    def _walk(node: Any) -> None:
        if isinstance(node, pim.ExpertStackedPlan):
            _walk(node.dense)
        elif isinstance(node, pim.DensePlan):
            if (node.abft is not None and node.cfg.verify != "off"
                    and node.cfg.abft_tag):
                tags.add(node.cfg.abft_tag)
        elif isinstance(node, dict):
            for v in node.values():
                _walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                _walk(v)

    _walk(tree)
    return sorted(tags)


def _get_subtree(tree: Any, path: str) -> Any:
    """Fetch the subtree at slash-joined ``path`` (a per-layer list of
    plans is addressed whole, as the JAX package's stacked plan is);
    unknown paths raise KeyError (ad-hoc eager tags do not name params
    subtrees)."""
    if not path:
        return tree
    head, _, rest = path.partition("/")
    if isinstance(tree, dict):
        if head not in tree:
            raise KeyError(f"no subtree {head!r} on repair path {path!r}")
        return _get_subtree(tree[head], rest)
    if isinstance(tree, (list, tuple)):
        try:
            return _get_subtree(tree[int(head)], rest)
        except (ValueError, IndexError):
            raise KeyError(f"no subtree {head!r} on repair path {path!r}")
    raise KeyError(f"cannot descend into {type(tree).__name__} at {path!r}")


def _set_subtree(tree: Any, path: str, value: Any) -> Any:
    """Return ``tree`` with the subtree at ``path`` replaced by ``value``
    (containers copied along the path, everything else shared)."""
    if not path:
        return value
    head, _, rest = path.partition("/")
    if isinstance(tree, dict):
        out = dict(tree)
        out[head] = _set_subtree(tree[head], rest, value)
        return out
    items = list(tree)
    i = int(head)
    items[i] = _set_subtree(items[i], rest, value)
    return items if isinstance(tree, list) else tuple(items)


class ReliabilityManager:
    """Violation ledger + retry/repair/degrade decisions for serving."""

    def __init__(self, params: Any, fault_models: Sequence[FaultModel] = (),
                 policy: Optional[ReliabilityPolicy] = None) -> None:
        self.policy = policy or ReliabilityPolicy()
        self.golden = params
        self.models = list(fault_models)
        self.params, self.injection_report = inject_tree(params, self.models)
        self.fallback = retarget_plans(params,
                                       self.policy.fallback_substrate)
        self.strikes: Dict[str, int] = {}      # violations since last repair
        self.repair_counts: Dict[str, int] = {}
        self.detections = 0                    # dispatches that tripped
        self.retries = 0
        self.repairs = 0
        self.deadline_expiries = 0             # filled by the scheduler
        self.degraded = False
        self.recovery_s: List[float] = []      # wall-clock per recovery
        self._armed_tags = armed_tags(self.params)

    # -- detection --------------------------------------------------------
    def drain(self) -> Dict[str, int]:
        """Return the per-tag violation counts delivered since the last
        drain. A clean dispatch posts no violation, so each drain also
        credits one check event per armed tag: drain runs once per
        verified primary dispatch, after the engine delivered its
        counts."""
        abft.FAULT_LOG.note_checks(self._armed_tags)
        return abft.FAULT_LOG.drain()

    def record_violations(self, by_tag: Dict[str, int]) -> None:
        for tag, count in by_tag.items():
            self.strikes[tag] = self.strikes.get(tag, 0) + count
        if by_tag:
            self.detections += 1

    # -- recovery ---------------------------------------------------------
    def serving_params(self) -> Any:
        """What the engine should serve against right now."""
        return self.fallback if self.degraded else self.params

    def note_retry(self, seconds: float = 0.0) -> None:
        self.retries += 1
        self.recovery_s.append(float(seconds))

    def maybe_repair(self) -> bool:
        """Re-program plans whose strike count crossed ``repair_after``
        from the golden store (sticky faults re-inject themselves).
        Returns True when anything was re-programmed: the caller must
        then invalidate prefix caches and re-bind its params. Plans
        repaired ``degrade_after`` times tip the whole engine into
        degraded mode (served from the exact fallback from then on)."""
        due = [t for t, s in self.strikes.items()
               if s >= self.policy.repair_after]
        if self.degraded:
            for tag in due:
                self.strikes.pop(tag, None)
            return False
        repaired = False
        sticky = [m for m in self.models if m.sticky]
        for tag in sorted(due):
            try:
                golden_sub = _get_subtree(self.golden, tag)
            except KeyError:
                # tag does not name a params subtree (e.g. an eager
                # caller's ad-hoc tag): strike bookkeeping only
                self.strikes.pop(tag, None)
                continue
            # re-program from golden, then re-inject only the hard
            # faults and only into this subtree (soft faults are cleared
            # by re-programming; other plans keep their injected state)
            fresh, _ = inject_tree(golden_sub, sticky, _path=tag)
            self.params = _set_subtree(self.params, tag, fresh)
            self.strikes.pop(tag, None)
            self.repair_counts[tag] = self.repair_counts.get(tag, 0) + 1
            self.repairs += 1
            repaired = True
            if self.repair_counts[tag] >= self.policy.degrade_after:
                self.degraded = True
        return repaired

    # -- reporting --------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        snap = abft.FAULT_LOG.snapshot()
        lat = sorted(self.recovery_s)
        return {
            "injected_faults": len(self.injection_report),
            "checks": snap["total_checks"],
            "violations": snap["total_violations"],
            "detections": self.detections,
            "retries": self.retries,
            "repairs": self.repairs,
            "deadline_expiries": self.deadline_expiries,
            "degraded": self.degraded,
            "recovery_latency_s": {
                "count": len(lat),
                "mean": sum(lat) / len(lat) if lat else 0.0,
                "max": lat[-1] if lat else 0.0,
            },
        }
