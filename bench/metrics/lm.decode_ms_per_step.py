"""lm.decode_ms_per_step: host clock of the engine's decode dispatches
(``ServingEngine.generate``: inputs placed, one step at the cell's
``sync_every`` of 1, its tokens on the host), averaged over the
dispatches that ended in the window outside the profiled stretch."""
SPANS = [{"target": "repro_torch.serving.engine:ServingEngine.generate",
          "label": "bench.generate", "times": True}]


def read(ctx):
    host = ctx["window"]["host"]
    took = [t1 - t0 for t0, t1 in ctx["times"].get("bench.generate", [])
            if host.holds(t1)]
    return 1e3 * sum(took) / len(took) if took else None
