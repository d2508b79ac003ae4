"""lm.slot_occupancy: occupied decode slots over all slots, per decode
step (the scheduler's ``mean_slot_occupancy``, counted by the harness):
the tokens decoded over the decode dispatches (one step each) times the
slots, both in the window outside the profiled stretch."""
from bench import yardstick

SPANS = [{"target": "repro_torch.serving.engine:ServingEngine.generate",
          "label": "bench.generate", "times": True}]


def read(ctx):
    w = ctx["window"]
    steps = sum(1 for _, t1 in ctx["times"].get("bench.generate", [])
                if w["host"].holds(t1))
    return yardstick.share(w["decoded"], steps * w["slots"]) if steps \
        else None
