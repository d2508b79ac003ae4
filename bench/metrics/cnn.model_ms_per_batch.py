"""cnn.model_ms_per_batch: device time inside the CNN forward that is not
the engine's matmuls (patch matrices, ReLUs, residual adds, the mean),
per batch of the traced stretch."""
SPANS = [
    {"target": "repro_torch.models.cnn:cnn_forward",
     "label": "bench.cnn_forward"},
    {"target": "repro_torch.engine:matmul", "label": "bench.engine"},
]


def read(ctx):
    t = ctx["trace"]
    batches = t.range_count("bench.cnn_forward") if t is not None else 0
    if not batches:
        return None
    model = t.range_device_s("bench.cnn_forward") - \
        t.range_device_s("bench.engine", within="bench.cnn_forward")
    return 1e3 * model / batches if model > 0 else None
