"""lm.decode_wait_ms_per_step: host time a decode dispatch spends blocked
on the device, per decode step: the program's span ``engine.fetch`` (the
dispatch's one device-to-host copy) inside each ``engine.generate`` that
ended in the window outside the profiled stretch, over those dispatches'
steps."""
from bench import program


def read(ctx):
    return program.decode_ms_per_step(ctx, ("engine.fetch",))
