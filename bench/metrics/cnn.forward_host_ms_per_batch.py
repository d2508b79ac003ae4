"""cnn.forward_host_ms_per_batch: host time of one CNN forward (the
program's span ``cnn.forward``: every layer's launches enqueued, and any
wait for the device inside it), the mean over the forwards that ended in
the window outside the profiled stretch. Well under the device's time a
batch, the host runs ahead of the device."""
from bench import program


def read(ctx):
    forwards = program.ended(ctx, "cnn.forward")
    if not forwards:
        return None
    return sum(f.ns for f in forwards) / 1e6 / len(forwards)
