"""ABFT column checksums for programmed PIM plans (counterpart of
``repro/reliability/abft.py``).

Algorithm-based fault tolerance in the Huang-Abraham style, adapted to
the weight-stationary datapath: at *programming* time each
:class:`~repro_torch.core.pim.DensePlan` records a checksum column

    col_i32[k]  = sum_n values[k, n]            (int32, exact)
    col_f32[k]  = sum_n values[k, n] * scale[n] (float, for analog routes)
    scale_sum   = sum_n scale[n]                (ADC calibration audit)

and at *execute* time the identity

    sum_n acc[m, n]  ==  sum_k a_q[m, k] * col_i32[k]

is checked against the int32 accumulator row-sums of the fused epilogue
(B1's ``want_rowsum`` on ``exact-cuda``). Both sides are the same
modular-int32 sum in another association order, so on the exact
substrates the comparison is bit-exact: any fault that perturbs a
weighted column sum of the stored planes (bit-flips, stuck nibble
planes, dropped WDM chunks) trips it. ADC gain/offset drift is caught by
re-summing the live scale row against ``scale_sum``. Analog substrates
check the float row-sums of the readout against ``a_scale * (a_q @
col_f32)`` under a noise-calibrated tolerance, plus an exact storage
audit of the nibble planes.

Detection is *reported*, never raised from inside a matmul: a verified
matmul hands its violation count (a 0-d tensor on the plan's device) to
:func:`report`. Inside a :func:`collect_scope` (the serving engine opens
one around each dispatch) the counts stay on the device, are summed per
tag into one vector when the scope closes, and the engine fetches that
vector at the dispatch's own sync, beside the tokens, and hands it to
:func:`deliver`: no host sync per matmul. Outside a scope, :func:`report`
records at once into the process-global :data:`FAULT_LOG` (a sync, which
eager callers accept). The JAX package's trace machinery (scopes keyed
to a jit trace, ``verified_scan`` for ``lax.scan`` bodies) has no
counterpart: the port runs its steps eagerly.

Verify policy (``PimConfig.verify``): ``"off"`` (no checksums),
``"sample"`` (one deterministically chosen row per matmul), ``"always"``
(every row).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.pim_matmul.ref import wrap_int32
from repro_torch.quant.nibbles import NIBBLE_BASE

VERIFY_MODES = ("off", "sample", "always")

# relative slack on the scale-row audit: both sides are sums of the same
# row, so they agree to the last few ulps whatever the summation order
# (a record programmed by the JAX package sums in XLA's order)
_SCALE_RTOL = 1e-5


class ChecksumViolation(RuntimeError):
    """An ABFT checksum mismatch surfaced to an eager caller."""


def _host_total(count) -> int:
    """The integer sum of a count (tensor, array or int) on the host."""
    if torch.is_tensor(count):
        return int(count.sum())
    return int(np.asarray(count).sum())


class FaultLog:
    """Process-global, thread-safe violation ledger.

    Written by :func:`report` (eager callers) and :func:`deliver` (the
    serving engine, once per dispatch), read by the degradation machine
    and the metrics report. ``checks`` counts verified dispatches per
    tag; ``violations`` counts dispatches that tripped (a multi-row
    mismatch in one dispatch is one detection event, but the raw row
    count is kept too)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._violations: Dict[str, int] = {}
        self._checks: Dict[str, int] = {}
        self._rows: Dict[str, int] = {}
        self.total_violations = 0
        self.total_checks = 0

    def record(self, tag: str, count) -> None:
        """One eager verified matmul: a check, and a violation if
        ``count`` is non-zero (a sync when ``count`` is on the card)."""
        n = _host_total(count)
        with self._lock:
            self._checks[tag] = self._checks.get(tag, 0) + 1
            self.total_checks += 1
            if n > 0:
                self._violations[tag] = self._violations.get(tag, 0) + 1
                self._rows[tag] = self._rows.get(tag, 0) + n
                self.total_violations += 1

    def record_breakdown(self, tags: Sequence[str], counts) -> None:
        """Violation-only accounting for one dispatch's fetched per-tag
        count vector: one ledger entry per violating tag. Check events
        are credited separately (:meth:`note_checks` for engine
        dispatches, :meth:`record` for eager callers)."""
        arr = np.asarray(counts)
        with self._lock:
            for tag, c in zip(tags, arr):
                n = int(np.asarray(c).sum())
                if n <= 0:
                    continue
                self._violations[tag] = self._violations.get(tag, 0) + 1
                self._rows[tag] = self._rows.get(tag, 0) + n
                self.total_violations += 1

    def note_checks(self, tags, n: int = 1) -> None:
        """Check accounting for engine dispatches: a clean dispatch posts
        no violation, so the serving engine credits one check event per
        armed tag per verified dispatch here."""
        with self._lock:
            for tag in tags:
                self._checks[tag] = self._checks.get(tag, 0) + n
                self.total_checks += n

    def drain(self) -> Dict[str, int]:
        """Return and clear the per-tag violation counts accumulated
        since the last drain (cumulative totals are preserved)."""
        with self._lock:
            out = dict(self._violations)
            self._violations.clear()
            return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"checks": dict(self._checks),
                    "violation_rows": dict(self._rows),
                    "total_checks": self.total_checks,
                    "total_violations": self.total_violations}

    def clear(self) -> None:
        with self._lock:
            self._violations.clear()
            self._checks.clear()
            self._rows.clear()
            self.total_violations = 0
            self.total_checks = 0


FAULT_LOG = FaultLog()


def raise_if_violations(by_tag: Dict[str, int]) -> None:
    """Eager convenience: raise :class:`ChecksumViolation` when a drained
    violation dict is non-empty."""
    if by_tag:
        detail = ", ".join(f"{t}: {c}" for t, c in sorted(by_tag.items()))
        raise ChecksumViolation(f"ABFT checksum violation(s): {detail}")


# ---------------------------------------------------------------------------
# programming-time checksum computation
# ---------------------------------------------------------------------------
def checksums(values: torch.Tensor, scale: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Checksum record for (..., K, N) int codes with (..., 1, N) scales
    (leading axes: an expert stack, one record per expert, as under the
    JAX package's vmap). ``col_i32`` is exact (int32 wraparound, as
    JAX's); the two float sums may differ from JAX's in the last ulps
    (another summation order)."""
    v = values.to(torch.int64)
    s = scale.to(torch.float32)
    return {
        "col_i32": wrap_int32(v.sum(dim=-1)),
        "col_f32": (values.to(torch.float32) * s).sum(dim=-1),
        "scale_sum": s.sum(dim=(-2, -1)),
    }


# ---------------------------------------------------------------------------
# execute-time verification
# ---------------------------------------------------------------------------
def _sample_row(tag: Optional[str], m: int) -> int:
    """Deterministic spot-check row for ``verify="sample"`` (a host int,
    varies across plans so sampling is not all row 0): JAX's."""
    h = hashlib.sha256((tag or "").encode()).digest()
    return int.from_bytes(h[:4], "little") % max(m, 1)


def scale_violations(scale: torch.Tensor, scale_sum: torch.Tensor
                     ) -> torch.Tensor:
    """1 iff the live scale row no longer sums to the programmed value
    (ADC gain/offset drift); 0 otherwise. int32 scalar on the scale's
    device."""
    live = scale.to(torch.float32).sum()
    ref = scale_sum.to(torch.float32)
    bad = torch.abs(live - ref) > _SCALE_RTOL * torch.abs(ref) + 1e-8
    return bad.to(torch.int32)


def plane_violations(planes: torch.Tensor, col_i32: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Exact storage audit: recombine the stored nibble planes and check
    their column sums against the programmed checksum column. planes
    (Pw, Kp, Np) signed base-16 digits; col_i32 (K,) with K <= Kp (the
    padded tail must sum to zero). Catches stuck planes, dropped WDM
    chunks and bit-flips in the device store, independent of the driven
    activations. int64 sums wrapped to int32, JAX's arithmetic."""
    pw, kp = planes.shape[-3], planes.shape[-2]
    shifts = NIBBLE_BASE ** torch.arange(pw, dtype=torch.int64,
                                         device=planes.device)
    live = wrap_int32((planes.to(torch.int64).sum(dim=-1)
                       * shifts[:, None]).sum(dim=0))          # (Kp,)
    expected = F.pad(col_i32.to(torch.int32), (0, kp - k))
    return (live != expected).sum(dtype=torch.int32)


def int_violations(rowsum: torch.Tensor, a_values: torch.Tensor,
                   abft: Dict[str, torch.Tensor], scale: torch.Tensor, *,
                   mode: str, tag: Optional[str] = None) -> torch.Tensor:
    """Exact-substrate check: ``rowsum`` (M,) int32 accumulator row-sums
    from the fused epilogue vs the checksum-column matvec. The matvec
    runs in float64, exact for these integers (|a . col| < 2^53; CUDA
    has no int32 matmul), and the two sides are compared modulo 2^32:
    int32 wraparound agrees on both (the same modular sum,
    re-associated), so the comparison is exact."""
    if mode == "sample":
        r = _sample_row(tag, rowsum.shape[0])
        rowsum, a_values = rowsum[r:r + 1], a_values[r:r + 1]
    diff = torch.addmv(rowsum.to(torch.float64), a_values.to(torch.float64),
                       abft["col_i32"].to(torch.float64), alpha=-1)
    bad = (torch.remainder(diff, 2.0 ** 32) != 0).sum(dtype=torch.int32)
    return bad + scale_violations(scale, abft["scale_sum"])


def float_violations(out_rowsum: torch.Tensor, expected: torch.Tensor,
                     tol: torch.Tensor, plan_planes: torch.Tensor,
                     abft: Dict[str, torch.Tensor], scale: torch.Tensor, *,
                     k: int, mode: str,
                     tag: Optional[str] = None) -> torch.Tensor:
    """Analog/emulate check: tolerance-banded output row-sums plus the
    exact storage audits (plane recombination + scale row). The storage
    audits carry the deterministic detection guarantee; the output band
    catches gross runtime corruption the stores cannot see."""
    if mode == "sample":
        r = _sample_row(tag, out_rowsum.shape[0])
        out_rowsum, expected, tol = (out_rowsum[r:r + 1], expected[r:r + 1],
                                     tol[r:r + 1])
    bad = (torch.abs(out_rowsum - expected) > tol).sum(dtype=torch.int32)
    return (bad + plane_violations(plan_planes, abft["col_i32"], k)
            + scale_violations(scale, abft["scale_sum"]))


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------
_SCOPES = threading.local()


def _scope_stack() -> List["CollectScope"]:
    stack = getattr(_SCOPES, "stack", None)
    if stack is None:
        stack = _SCOPES.stack = []
    return stack


class CollectScope:
    """One open report-collection region (see :func:`collect_scope`).

    After exit, ``names`` holds the sorted tuple of tags reported while
    the scope was open and :meth:`counts` the matching (len(names),)
    int32 per-tag violation counts, still on the device."""

    __slots__ = ("names", "_buf", "_counts")

    def __init__(self) -> None:
        self.names: Tuple[str, ...] = ()
        self._buf: List[Tuple[str, torch.Tensor]] = []
        self._counts: Optional[torch.Tensor] = None

    def counts(self) -> Optional[torch.Tensor]:
        """The per-tag counts in ``names`` order (None when nothing was
        reported). Available once the scope has exited."""
        return self._counts

    def _close(self) -> None:
        if not self._buf:
            return
        # grouped by tag on the host, so no index goes to the device (a
        # copy from host memory would wait for the card)
        by_tag: Dict[str, List[torch.Tensor]] = {}
        for name, v in self._buf:
            by_tag.setdefault(name, []).append(
                v.reshape(()).to(torch.int32))
        self.names = tuple(sorted(by_tag))
        self._counts = torch.stack([
            torch.stack(by_tag[name]).sum(dtype=torch.int32)
            for name in self.names])
        self._buf = []


@contextlib.contextmanager
def collect_scope():
    """Collect every :func:`report` issued while the scope is open: the
    counts stay on the device and are summed per tag, in a few launches,
    when it closes. The caller reads :meth:`CollectScope.counts` after
    exit, fetches it with the dispatch's own results and hands it to
    :func:`deliver`. Scopes nest; a report goes to the innermost."""
    stack = _scope_stack()
    scope = CollectScope()
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.pop()
        scope._close()


def deliver(names: Sequence[str], counts) -> int:
    """Host-side sink for a scope's fetched count vector: records any
    non-zero tags in :data:`FAULT_LOG` and returns the total
    violation-row count (0 on the clean path)."""
    arr = np.asarray(counts)
    total = int(arr.sum()) if arr.size else 0
    if total > 0:
        FAULT_LOG.record_breakdown(names, arr)
    return total


def report(tag: Optional[str], violations: torch.Tensor) -> None:
    """Post a verified matmul's violation count. Inside a collect scope
    the count is buffered on the device for the scope's one delivery;
    otherwise the call records at once (check and violation both
    counted), which waits for the device."""
    name = tag or "<untagged>"
    stack = _scope_stack()
    if stack:
        stack[-1]._buf.append((name, violations))
        return
    FAULT_LOG.record(name, violations)
