"""The harness that runs one cell: it finds the cell's configuration,
traffic and metric readers by name from ``BENCHMARK.json``, drives the
configuration's driver through set-up, the measured window and the
correctness check, and assembles the result line.

Data-driven: a configuration names its driver (``bench/drivers/<driver>.py``)
and a per-layer metric is read by ``bench/metrics/<metric>.py``, so a new
cell or metric is new files plus new entries. A metric reader declares the
spans it needs (``SPANS``); the harness wraps those program functions. A
span marked ``times`` keeps each call's host interval in every run (the
per-layer host-clock readings, which leave the profiled stretch out); the
others exist in a ``--trace 1`` run only, as
``torch.profiler.record_function`` ranges (with, where asked, the shapes
of their tensor arguments) inside the traced stretch.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Sequence

from bench import yardstick

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A cell that cannot run as the benchmark describes it."""


def forbidden_modules(names: Optional[Sequence[str]] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics, all found by name."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = root
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise BenchError(f"no workload named {workload!r}; the "
                             f"benchmark has {sorted(cells)}")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(BENCH_DIR / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.chips = int(self.workload["chips"])

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self) -> ModuleType:
        return importlib.import_module(f"bench.drivers.{self.config['driver']}")

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_reader(m["name"]) for m in self.per_layer}


def load_reader(name: str) -> ModuleType:
    """``bench/metrics/<name>.py`` as a module (names hold dots, so it is
    loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use_cache_dirs() -> None:
    """Fixed cache directories inside the checkout: the port's kernel
    libraries and, should anything use Triton, its cache. Only a cell's
    first run in a checkout builds."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    from repro_torch.kernels import runtime
    runtime.set_build_dir(CACHE_DIR / "kernels")


# ---------------------------------------------------------------------------
# spans: ranges around the program's functions, for the traced stretch
# ---------------------------------------------------------------------------
def _resolve(target: str):
    """``"module:attr.attr"`` -> (owner object, attribute name)."""
    mod_name, path = target.split(":")
    owner: Any = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def _shapes(args) -> List:
    return [tuple(a.shape) if hasattr(a, "shape") and hasattr(a, "dtype")
            else None for a in args]


class Spans:
    """Wrappers around program functions. Ranges (``record_function``)
    and argument shapes are recorded while ``active``; a span marked
    ``times`` keeps every call's (start, end) on the host clock in
    ``times``. ``traced`` False keeps only the ``times`` spans."""

    def __init__(self, specs: Sequence[Dict], traced: bool = True):
        seen, self.specs = set(), []
        for s in specs:
            key = (s["target"], s["label"])
            if key not in seen and (traced or s.get("times")):
                seen.add(key)
                self.specs.append(s)
        self.active = False
        self.calls: Dict[str, List] = {s["label"]: [] for s in self.specs}
        self.times: Dict[str, List] = {s["label"]: [] for s in self.specs
                                       if s.get("times")}
        self._saved: List = []

    @property
    def labels(self) -> List[str]:
        return [s["label"] for s in self.specs]

    def _wrap(self, fn: Callable, spec: Dict) -> Callable:
        from torch.profiler import record_function
        label, shapes = spec["label"], bool(spec.get("shapes"))
        calls, times = self.calls[label], self.times.get(label)

        def call(args, kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            if shapes:
                calls.append((_shapes(args),
                              {k: _shapes([v])[0] for k, v in kwargs.items()
                               if v is not None}))
            with record_function(label):
                return fn(*args, **kwargs)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if times is None:
                return call(args, kwargs)
            t0 = time.perf_counter()
            out = call(args, kwargs)
            times.append((t0, time.perf_counter()))
            return out
        return wrapper

    def install(self) -> None:
        for spec in self.specs:
            owner, attr = _resolve(spec["target"])
            fn = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, spec))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------
class Tracer:
    """A ``torch.profiler`` session over a stretch of the window, started
    and stopped by the driver, with the readers' spans active inside it.
    ``enabled`` False (a ``--trace 0`` run) makes both calls no-ops."""

    def __init__(self, enabled: bool, spans: Spans, driver_labels=()):
        self.enabled = enabled
        self.spans = spans
        self.driver_labels = tuple(driver_labels)
        self._prof = None
        self.summary: Optional["TraceSummary"] = None

    def warm(self) -> None:
        """One throwaway session before the window: the profiler's first
        start (CUPTI's set-up) takes seconds, and belongs to set-up."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled or self._prof is not None or \
                self.summary is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.spans.active = True

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self.spans.active = False
        self._prof.stop()
        self._done, self._prof = self._prof, None

    def reduce(self) -> Optional["TraceSummary"]:
        """Reduce the stopped session's events (after the window)."""
        done = getattr(self, "_done", None)
        if self.summary is None and done is not None:
            self.summary = TraceSummary(done.events(), self.spans,
                                        self.driver_labels)
            self._done = None
        return self.summary


class TraceSummary:
    """What the readers take from a traced stretch: device activity
    (kernels, copies, sets) with names and times, the host ranges of the
    spans with the device time of the work launched inside each, the
    recorded argument shapes, busy time and the stretch's length. Times in
    seconds."""

    def __init__(self, events, spans: Spans, driver_labels=()):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        cpu = torch.autograd.DeviceType.CPU
        labels = set(spans.labels) | set(driver_labels)
        self.device: List = []          # (name, start_s, end_s)
        self.ranges: Dict[str, List] = {l: [] for l in labels}
        starts, ends = [], []
        for e in events:
            t0, t1 = e.time_range.start / 1e6, e.time_range.end / 1e6
            starts.append(t0)
            ends.append(t1)
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False) or \
                        e.name in labels:
                    continue
                self.device.append((e.name, t0, t1))
            elif e.device_type == cpu and e.name in labels:
                self.ranges[e.name].append(
                    (t0, t1, e.device_time_total / 1e6))
        self.device.sort(key=lambda d: d[1])
        self.calls = spans.calls
        self.busy_s = yardstick.busy_time((s, e) for _, s, e in self.device)
        self.window_s = (max(ends) - min(starts)) if starts else 0.0

    def kernels(self, fragments: Sequence[str]) -> List:
        """Device activities whose name holds one of ``fragments``, in
        start order."""
        return [d for d in self.device
                if any(f in d[0] for f in fragments)]

    def range_count(self, label: str) -> int:
        return len(self.ranges.get(label, []))

    def range_device_s(self, label: str,
                       within: Optional[str] = None) -> float:
        """Device time of the work launched inside ``label``'s ranges,
        optionally only those ranges that lie inside one of ``within``'s
        (host intervals)."""
        rs = self.ranges.get(label, [])
        if within is not None:
            outer = self.ranges.get(within, [])
            rs = [r for r in rs if any(o[0] <= r[0] and r[1] <= o[1]
                                       for o in outer)]
        return sum(r[2] for r in rs)

    def top_device_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in top]

    def top_idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps, each named by the innermost span the
        host was in at the gap's middle."""
        gaps = yardstick.idle_gaps((s, e) for _, s, e in self.device)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            mid = 0.5 * (g0 + g1)
            inner = None
            for label, rs in self.ranges.items():
                for r0, r1, _ in rs:
                    if r0 <= mid <= r1 and (inner is None
                                             or r1 - r0 < inner[0]):
                        inner = (r1 - r0, label)
            out.append([inner[1] if inner else "outside the spans",
                        g1 - g0])
        return out


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------
def device_info(chips: int) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def metric(value: float, unit: str) -> Dict[str, Any]:
    return {"value": float(value), "unit": unit}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", log=print,
        t0: Optional[float] = None) -> Dict[str, Any]:
    """Set up, measure and check one cell; returns the result dict (the
    last line, without the checks' stderr lines). ``device`` "cpu" runs
    the program's plain versions at whatever size the configuration
    holds (the tests' path)."""
    readers = cell.readers()
    spans = Spans([s for r in readers.values()
                   for s in getattr(r, "SPANS", ())], traced=trace)
    drv = cell.driver()
    tracer = Tracer(trace and device != "cpu", spans,
                    getattr(drv, "DRIVER_LABELS", ()))
    system = drv.System(cell, seed, device, log,
                        time.perf_counter() if t0 is None else t0)
    system.setup()
    tracer.warm()
    spans.install()
    try:
        win = system.window(seconds, tracer)
    finally:
        tracer.stop()
        spans.remove()
    dev = device_info(cell.chips) if device != "cpu" else {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0}
    summary = tracer.reduce()
    ctx = {"window": win, "trace": summary, "times": spans.times,
           "config": cell.config, "traffic": cell.traffic}
    layer_metrics: Dict[str, Any] = {}
    for m in cell.per_layer:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            layer_metrics[m["name"]] = metric(value, m["unit"])
    if trace:
        metrics = layer_metrics
    else:
        # an untraced run's per-layer readings (host clock and counters),
        # on an earlier line only
        log("untraced per-layer: " + json.dumps(
            {k: v["value"] for k, v in layer_metrics.items()}))
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] in win["end_to_end"]:
                metrics[m["name"]] = metric(win["end_to_end"][m["name"]],
                                            m["unit"])
    system.release()
    checks, correct = system.check()
    result: Dict[str, Any] = {"correct": bool(correct),
                              "attempted": int(win["attempted"]),
                              "failed": int(win["failed"]),
                              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_device_ops(),
                               "idle_gaps": summary.top_idle_gaps()}
    result["checks"] = checks
    return result
