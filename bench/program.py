"""The program's own spans and counters (``repro_torch.analysis.trace``),
for the readers of the metrics that read them.

Importing this module arms one recorder for the process. The harness
loads every reader before set-up, so a reader that imports this module
has the whole window recorded in every run, as the ``times`` spans are.
A program without the recorder (one older than its tracing layer)
records nothing: the helpers then return nothing, and the readers
``None``.
"""
from typing import Optional, Sequence

try:
    from repro_torch.analysis import trace
except ImportError:
    trace = None

RECORDER = None
if trace is not None:
    RECORDER = trace.Recorder()
    RECORDER.__enter__()


def ended(ctx, name: str) -> list:
    """The program's spans named ``name`` that ended inside the window
    outside the profiled stretch (``ctx["window"]["host"]``), in end
    order."""
    if RECORDER is None:
        return []
    host = ctx["window"]["host"]
    return [r for r in RECORDER.spans(name) if host.holds(r.end_ns / 1e9)]


def decode_ms_per_step(ctx, parts: Sequence[str]) -> Optional[float]:
    """Host ms of the spans named in ``parts`` directly inside each
    decode dispatch (``engine.generate``) that ended in the window outside
    the profiled stretch, over those dispatches' steps."""
    dispatches = ended(ctx, "engine.generate")
    steps = sum(d.attrs.get("steps", 0) for d in dispatches)
    if not steps:
        return None
    inside = RECORDER.children(dispatches)
    ns = sum(c.ns for d in dispatches for c in inside[d.id]
             if c.name in parts)
    return ns / 1e6 / steps
