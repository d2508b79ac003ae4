"""cnn.glue_ms_per_batch: device time of the substrate glue (activation
quantization with its nibble planes, and the planes' K padding) per batch
of the traced stretch."""
SPANS = [
    {"target": "repro_torch.core.pim:_quantize_activations",
     "label": "bench.glue.quantize"},
    {"target": "repro_torch.core.pim:_pad_act_planes",
     "label": "bench.glue.pad"},
]


def read(ctx):
    t = ctx["trace"]
    batches = t.range_count("bench.batch") if t is not None else 0
    if not batches:
        return None
    glue = t.range_device_s("bench.glue.quantize") + \
        t.range_device_s("bench.glue.pad")
    return 1e3 * glue / batches if glue > 0 else None
