"""In-process spans and counters of the port: the tracing layer beside
:mod:`repro_torch.analysis.sanitize`, and the one registry of armed
consumers both use.

The program marks its layer boundaries with three calls:

* :func:`span` ``(name, **attrs)`` — a coarse span (scheduler, engine,
  model forward), as a context manager or a decorator. Each keeps one
  :class:`SpanRecord`: its name, start and end on
  ``time.perf_counter_ns()``, the id of the enclosing coarse span on the
  same thread (its parent), its attributes (a request's spans carry the
  request's id), and the host time of the spans directly inside it, so
  that a span's self time is its duration less its children's.
* :func:`fine` ``(name, key=None)`` — a fine span (per matmul, per
  launch): kept as an aggregate per ``(name, key)``, its count and total
  host ns, so a window of thousands of launches costs a dictionary entry
  per shape. Fine spans are leaves: none opens inside another.
* :func:`count` ``(name, n=1, **key)`` — a counter at the same boundaries.

Nothing is recorded while no :class:`Recorder` is armed: ``span`` and
``fine`` then cost one check of a module-level tuple and return a shared
null context, and ``count`` returns.

::

    with trace.Recorder() as rec:
        scheduler.run(requests)
    rec.spans("engine.generate")       # coarse records, in end order
    rec.summary()                      # count, total and self ms per name

While a ``torch.profiler`` session is active, every span, fine ones
included, also enters a profiler range of its name (``record_function``'s
RecordFunction, entered at C level): its interval lies on the profiler's
timeline, on the profiler's clock, and the kernels launched inside it are
attributed to it.

A :class:`Recorder` made with ``spans=False`` keeps only counters; the
compile counter of :mod:`repro_torch.analysis.sanitize` reads one
(:data:`COMPILE`, keyed by ``target``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
from time import perf_counter_ns
from typing import Any, Dict, Hashable, List, Optional, Tuple

from torch._C import _profiler as _cprofiler
from torch.autograd import profiler as _profiler

# every armed recorder, and those of them that keep spans; replaced whole
# (under _LOCK) on arming and disarming, so a reader sees one or the other
_ARMED: Tuple["Recorder", ...] = ()
_SPANNED: Tuple["Recorder", ...] = ()
_LOCK = threading.Lock()
# per thread: the open coarse spans, innermost last
_TLS = threading.local()
_IDS = itertools.count(1)

# a profiler range entered at C level: record_function's own RecordFunction,
# without its two Python-dispatched operator calls (an eighth of its host
# time); record_function itself where this torch lacks it
_RANGE = getattr(_cprofiler, "_RecordFunctionFast", None) or \
    _profiler.record_function

# the counter the compile counter reads: one per new step signature and
# per kernel build, keyed by ``target``
COMPILE = "compile"


@dataclasses.dataclass
class SpanRecord:
    """One coarse span. ``child_ns``: host time of the spans directly
    inside it (coarse children and fine spans) on its thread."""

    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    child_ns: int
    attrs: Dict[str, Any]
    thread: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.ns - self.child_ns


def _mirror(name: str):
    """A profiler range named ``name``, entered, while a profiler session
    is active; else None."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _RANGE(name)
    rf.__enter__()
    return rf


def _open_spans() -> List["_Span"]:
    try:
        return _TLS.open
    except AttributeError:
        _TLS.open = []
        return _TLS.open


class _Null:
    """What :func:`span` and :func:`fine` return while nothing is armed:
    a context manager that does nothing and, as a decorator, a wrapper
    that asks again at each call. One per span name (the decorator needs
    the name), and one nameless for the rest."""

    __slots__ = ("name",)

    def __init__(self, name: Optional[str]):
        self.name = name

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def __call__(self, fn):
        return _decorate(fn, self.name)


_NULL = _Null(None)
_NULLS: Dict[str, _Null] = {}


def _decorate(fn, name: Optional[str]):
    """``fn`` with each call a span named ``name``; a span given
    attributes decorates nothing (they belong to one call)."""
    if name is None:
        raise TypeError("a span with attributes cannot decorate a function")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


class _Span:
    """A live coarse span (see :func:`span`)."""

    __slots__ = ("name", "attrs", "recs", "id", "parent", "t0", "child_ns",
                 "rf")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 recs: Tuple["Recorder", ...]):
        self.name, self.attrs, self.recs = name, attrs, recs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        self.parent = stack[-1].id if stack else None
        self.id = next(_IDS)
        self.child_ns = 0
        self.rf = _mirror(self.name)
        stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = perf_counter_ns()
        stack = _open_spans()
        stack.pop()
        if stack:
            stack[-1].child_ns += t1 - self.t0
        rec = SpanRecord(self.id, self.parent, self.name, self.t0, t1,
                         self.child_ns, self.attrs, threading.get_ident())
        for r in self.recs:
            r.records.append(rec)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False

    def __call__(self, fn):
        return _decorate(fn, None if self.attrs else self.name)


class _Fine:
    """A live fine span (see :func:`fine`)."""

    __slots__ = ("key", "recs", "t0", "rf")

    def __init__(self, key: Tuple[str, Hashable],
                 recs: Tuple["Recorder", ...]):
        self.key, self.recs = key, recs

    def __enter__(self) -> "_Fine":
        self.rf = _mirror(self.key[0]) if _profiler._is_profiler_enabled \
            else None
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = perf_counter_ns() - self.t0
        stack = getattr(_TLS, "open", None)
        if stack:
            stack[-1].child_ns += ns
        thread = threading.get_ident()
        for r in self.recs:
            # this thread's own aggregates: no other thread writes them
            mine = r._fine_parts.get(thread)
            if mine is None:
                mine = r._fine_part(thread)
            agg = mine.get(self.key)
            if agg is None:
                mine[self.key] = [1, ns]
            else:
                agg[0] += 1
                agg[1] += ns
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str, **attrs):
    """A coarse span named ``name`` with ``attrs``, as a context manager
    (``with span("engine.generate", steps=1) as s: ... s.set(k=v)``) or,
    given no attributes, a decorator (``@span("cnn.forward")``: each call
    is a span)."""
    if not _SPANNED:
        if attrs:
            return _NULL
        null = _NULLS.get(name)
        return null if null is not None else _NULLS.setdefault(
            name, _Null(name))
    return _Span(name, attrs, _SPANNED)


def fine(name: str, key: Hashable = None):
    """A fine span: its count and host ns are added to the ``(name,
    key)`` aggregate of every armed recorder (``key`` a hashable, such as
    a launch's route and shapes)."""
    if not _SPANNED:
        return _NULL
    return _Fine((name, key), _SPANNED)


def count(name: str, n: int = 1, **key) -> None:
    """Add ``n`` to the counter ``name`` (``key``: its keyword labels) of
    every armed recorder."""
    if not _ARMED:
        return
    for r in _ARMED:
        r.add(name, n, **key)


def _rearm() -> None:
    global _SPANNED
    _SPANNED = tuple(r for r in _ARMED if r.keeps_spans)


class Recorder:
    """Spans and counters recorded while armed (``with Recorder() as
    rec:``; arming twice nests). ``spans=False`` keeps counters only.

    ``records``: the coarse :class:`SpanRecord` s, in end order.
    ``fine``: ``(name, key) -> [count, ns]``. ``counters``: ``(name,
    ((label, value), ...)) -> n``."""

    def __init__(self, spans: bool = True):
        self.keeps_spans = spans
        self.records: List[SpanRecord] = []
        self.counters: Dict[Tuple[str, Tuple], int] = {}
        self._lock = threading.Lock()
        # thread ident -> that thread's fine aggregates
        self._fine_parts: Dict[int, Dict[Tuple[str, Hashable],
                                         List[int]]] = {}

    def _fine_part(self, thread: int) -> Dict[Tuple[str, Hashable],
                                               List[int]]:
        with self._lock:
            return self._fine_parts.setdefault(thread, {})

    @property
    def fine(self) -> Dict[Tuple[str, Hashable], List[int]]:
        """The fine spans' ``(name, key) -> [count, ns]`` over every
        thread."""
        with self._lock:
            parts = [p.copy() for p in self._fine_parts.values()]
        out: Dict[Tuple[str, Hashable], List[int]] = {}
        for part in parts:
            for k, (n, ns) in part.items():
                agg = out.setdefault(k, [0, 0])
                agg[0] += n
                agg[1] += ns
        return out

    def __enter__(self) -> "Recorder":
        global _ARMED
        with _LOCK:
            _ARMED = _ARMED + (self,)
            _rearm()
        return self

    def __exit__(self, *exc) -> bool:
        global _ARMED
        with _LOCK:
            armed = list(_ARMED)
            armed.remove(self)
            _ARMED = tuple(armed)
            _rearm()
        return False

    def add(self, name: str, n: int = 1, **key) -> None:
        """Add ``n`` to this recorder's counter ``name`` alone."""
        k = (name, tuple(sorted(key.items())))
        with self._lock:
            self.counters[k] = self.counters.get(k, 0) + n

    # -- readers ----------------------------------------------------------
    def spans(self, name: str) -> List[SpanRecord]:
        """The coarse spans named ``name``, in end order."""
        return [r for r in self.records if r.name == name]

    def children(self, parents: List[SpanRecord]
                 ) -> Dict[int, List[SpanRecord]]:
        """Parent id -> its coarse children, for the ``parents`` given."""
        out: Dict[int, List[SpanRecord]] = {p.id: [] for p in parents}
        for r in self.records:
            if r.parent in out:
                out[r.parent].append(r)
        return out

    def aggregate(self, name: str) -> Dict[Hashable, Tuple[int, int]]:
        """The fine span ``name``'s key -> (count, host ns)."""
        return {k: (a[0], a[1]) for (n, k), a in self.fine.items()
                if n == name}

    def counter(self, name: str, **key) -> int:
        with self._lock:
            return self.counters.get((name, tuple(sorted(key.items()))), 0)

    def counted(self, name: str) -> Dict[Tuple, int]:
        """Every label set of the counter ``name`` -> its count."""
        with self._lock:
            return {k: n for (c, k), n in self.counters.items() if c == name}

    def summary(self) -> Dict[str, Any]:
        """Per span name: ``count``, ``total_ms`` and ``self_ms`` (fine
        spans are leaves: self is total); per counter (labels in brackets
        after the name): its count."""
        spans: Dict[str, List[float]] = {}
        for r in self.records:
            s = spans.setdefault(r.name, [0, 0, 0])
            s[0] += 1
            s[1] += r.ns
            s[2] += r.self_ns
        fine = [(n, a[0], a[1]) for (n, _), a in self.fine.items()]
        with self._lock:
            counters = dict(self.counters)
        for name, n, ns in fine:
            s = spans.setdefault(name, [0, 0, 0])
            s[0] += n
            s[1] += ns
            s[2] += ns
        out_counters = {}
        for (name, labels), n in sorted(counters.items(), key=str):
            tag = ",".join(f"{k}={v}" for k, v in labels)
            out_counters[f"{name}[{tag}]" if tag else name] = n
        return {"spans": {name: {"count": int(s[0]),
                                 "total_ms": s[1] / 1e6,
                                 "self_ms": s[2] / 1e6}
                          for name, s in sorted(spans.items())},
                "counters": out_counters}
