"""Runtime sanitizers for the serving hot path (counterpart of
``repro/analysis/sanitize.py``).

* :class:`Sanitizer` — wraps each decode step call of the serving
  engine in a guard against blocking host reads. On a CUDA device the
  guard is ``torch.cuda.set_sync_debug_mode("error")``: every
  synchronizing call PyTorch makes (a read of a tensor's value, a copy
  between host and pageable memory, a stream sync) raises, at no
  per-op cost. On the CPU, where nothing synchronizes, a
  :class:`~torch.overrides.TorchFunctionMode` raises on the same
  Python-level reads (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``bool()`` / ``int()`` / ``float()`` / ``index`` of a
  tensor, ``.to()`` another device) and on a tensor built from host data
  (``torch.tensor`` / ``torch.as_tensor``), so a CPU run catches the same
  scalar copies as the card. Reads outside the window (the engine's
  placement of the step inputs and its one copy of the results) stay
  legal, as JAX's explicit ``device_put`` / ``device_get`` do.
  ``nan_debug`` makes each dispatch inside :meth:`Sanitizer.session`
  raise ``FloatingPointError`` when its float outputs hold a NaN; the
  count rides in the dispatch's one device-to-host copy.

* :class:`CompileCounter` — counts, per name, each *new* step-input
  signature the serving engine runs (under the JAX package's jit names:
  ``prefill``, ``prefill_chunk``, ``insert``, ``decode``,
  ``decode_window``, and ``*_fb`` for the fallback replays) and each
  ``nvcc`` build the kernel runtime runs (``nvcc:<source>``): the port's
  compiles. ``counter.expect(prefill=1, decode=1)`` is the serving
  claim that every step runs at one signature. :func:`record_compile`
  is a counter of :mod:`repro_torch.analysis.trace` (``compile``, keyed
  by ``target``), and a compile counter reads the counters-only
  :class:`~repro_torch.analysis.trace.Recorder` it arms: one registry of
  armed consumers for the tracing and the sanitizers.

This module imports torch; :mod:`repro_torch.analysis` itself does not.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Union

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis import trace


def record_compile(name: str) -> None:
    """Count one compile of ``name`` for every armed recorder (and so for
    every armed :class:`CompileCounter`)."""
    trace.count(trace.COMPILE, target=name)


class CompileCountError(AssertionError):
    """A step compiled a different number of times than the serving
    invariant allows."""


class CompileCounter:
    """Counts compiles per name while armed.

    ::

        with CompileCounter(names=("prefill", "decode")) as counter:
            run_serving()
        counter.expect(prefill=1, decode=1)

    ``names`` limits counting to the steps under test; an entry ending in
    ``:`` counts every name it prefixes (``"nvcc:"`` counts each kernel
    build).
    """

    def __init__(self, names: Optional[Sequence[str]] = None) -> None:
        self.names = tuple(names) if names is not None else None
        self._recorder = trace.Recorder(spans=False)

    def _wanted(self, name: str) -> bool:
        return self.names is None or any(
            name == n or (n.endswith(":") and name.startswith(n))
            for n in self.names)

    def record(self, name: str) -> None:
        """Count one compile of ``name`` here alone."""
        self._recorder.add(trace.COMPILE, target=name)

    @property
    def counts(self) -> Dict[str, int]:
        """Compiles per name counted while armed (the names wanted)."""
        out: Dict[str, int] = {}
        for labels, n in self._recorder.counted(trace.COMPILE).items():
            name = dict(labels)["target"]
            if self._wanted(name):
                out[name] = n
        return out

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "CompileCounter":
        self._recorder.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._recorder.__exit__(*exc)

    # -- assertions -----------------------------------------------------
    def count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def expect(self, **expected: int) -> None:
        """Raise :class:`CompileCountError` unless every ``name=count``
        matches exactly."""
        bad = {name: (self.count(name), want)
               for name, want in expected.items()
               if self.count(name) != want}
        if bad:
            detail = ", ".join(
                f"{name}: compiled {got}x, expected {want}"
                for name, (got, want) in sorted(bad.items()))
            raise CompileCountError(
                f"compile-count sentinel tripped — {detail} "
                f"(all counts: {self.counts})")


class HostSyncError(RuntimeError):
    """A blocking host read inside a guarded decode window (the CPU
    guard's counterpart of a CUDA sync-debug error)."""


_READS = {torch.Tensor.item: "Tensor.item",
          torch.Tensor.tolist: "Tensor.tolist",
          torch.Tensor.cpu: "Tensor.cpu",
          torch.Tensor.numpy: "Tensor.numpy",
          torch.Tensor.__bool__: "bool() of a tensor",
          torch.Tensor.__int__: "int() of a tensor",
          torch.Tensor.__float__: "float() of a tensor",
          torch.Tensor.__index__: "index() of a tensor",
          torch.Tensor.__complex__: "complex() of a tensor"}


def _target_device(args, kwargs) -> Optional[torch.device]:
    """The device a ``Tensor.to`` call moves to (None: same device)."""
    if kwargs.get("device") is not None:
        return torch.device(kwargs["device"])
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            return torch.device(a)
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _host_read(func, args, kwargs) -> Optional[str]:
    """What ``func(*args, **kwargs)`` reads from or copies to the host,
    or None."""
    what = _READS.get(func)
    if what is not None:
        return what
    if func is torch.Tensor.to:
        dst = _target_device(args, kwargs)
        if dst is not None and dst != args[0].device and not (
                dst.index is None and dst.type == args[0].device.type):
            return f"Tensor.to({dst})"
        return None
    if func in (torch.tensor, torch.as_tensor):
        data = args[0] if args else kwargs.get("data")
        if not isinstance(data, torch.Tensor):
            return f"torch.{func.__name__} of host data"
        dst = kwargs.get("device")
        if dst is not None and torch.device(dst).type != data.device.type:
            return f"torch.{func.__name__} to {dst}"
    return None


class _HostReadGuard(TorchFunctionMode):
    """Raises :class:`HostSyncError` on a host read (see the module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = _host_read(func, args, kwargs)
        if what is not None:
            raise HostSyncError(
                f"{what} inside the guarded decode window: a blocking "
                "host read (on the card, a synchronizing CUDA operation)")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _sync_error_mode() -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block; the
    previous mode comes back on exit, also when the block raised."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@dataclasses.dataclass
class Sanitizer:
    """Runtime guard configuration threaded into the serving engine.

    ``transfer_guard`` arms the host-read guard around each decode step
    call; ``nan_debug`` arms the NaN check for dispatches run inside
    :meth:`session`.
    """

    transfer_guard: bool = True
    nan_debug: bool = False
    _sessions: int = dataclasses.field(default=0, init=False, repr=False)

    def decode_guard(self, device: Union[None, str, torch.device] = None
                     ) -> contextlib.AbstractContextManager:
        """Context manager wrapped around each decode step call on
        ``device`` (None: CUDA when a card is present). Blocking host
        reads raise inside it."""
        if not self.transfer_guard:
            return contextlib.nullcontext()
        dev = torch.device(device) if device is not None else torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
        if dev.type == "cuda":
            return _sync_error_mode()
        return _HostReadGuard()

    @property
    def nan_armed(self) -> bool:
        """Whether dispatches now check their outputs for NaNs."""
        return self.nan_debug and self._sessions > 0

    @contextlib.contextmanager
    def session(self) -> Iterator["Sanitizer"]:
        """Session-wide wiring: the NaN check when ``nan_debug``."""
        self._sessions += 1
        try:
            yield self
        finally:
            self._sessions -= 1

    def compile_counter(self, names: Optional[Sequence[str]] = None
                        ) -> CompileCounter:
        return CompileCounter(names=names)

    def report(self) -> Dict[str, object]:
        """Which guards were armed, plus the process-global ABFT fault
        log's counters, for a metrics dump."""
        from repro_torch.reliability import FAULT_LOG
        return {"transfer_guard": self.transfer_guard,
                "nan_debug": self.nan_debug,
                "fault_log": FAULT_LOG.snapshot()}
