"""lm.queue_ms_p50: median time from a request's send (its client's
previous request finished) to the start of its prefill
(``ServingEngine.start_prefill``; the backlog is served in order, so the
k-th start is request k's), over the prefills that started in the window
outside the profiled stretch."""
from bench import yardstick

SPANS = [{"target": "repro_torch.serving.engine:ServingEngine.start_prefill",
          "label": "bench.start_prefill", "times": True}]


def read(ctx):
    w = ctx["window"]
    starts = ctx["times"].get("bench.start_prefill", [])
    q = [(t0 - w["sends"][k]) * 1e3 for k, (t0, _) in enumerate(starts)
         if k < len(w["sends"]) and w["host"].holds(t0)]
    return yardstick.percentile(q, 50) if q else None
