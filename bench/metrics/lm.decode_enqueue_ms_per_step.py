"""lm.decode_enqueue_ms_per_step: host time a decode dispatch spends
before it waits for the device, per decode step: the program's spans
``engine.place`` (the step inputs placed on the device) and
``engine.step`` (the step's launches enqueued) inside each
``engine.generate`` that ended in the window outside the profiled
stretch, over those dispatches' steps."""
from bench import program


def read(ctx):
    return program.decode_ms_per_step(ctx, ("engine.place", "engine.step"))
