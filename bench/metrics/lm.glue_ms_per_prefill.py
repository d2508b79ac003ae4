"""lm.glue_ms_per_prefill: device time of the substrate glue (activation
quantization with its nibble planes, and the planes' K padding) inside
the engine's whole prefills, per prefill of the traced stretch."""
SPANS = [
    {"target": "repro_torch.core.pim:_quantize_activations",
     "label": "bench.glue.quantize"},
    {"target": "repro_torch.core.pim:_pad_act_planes",
     "label": "bench.glue.pad"},
    {"target": "repro_torch.serving.engine:ServingEngine._prefill_fn",
     "label": "bench.prefill"},
]


def read(ctx):
    t = ctx["trace"]
    prefills = t.range_count("bench.prefill") if t is not None else 0
    if not prefills:
        return None
    glue = sum(t.range_device_s(label, within="bench.prefill")
               for label in ("bench.glue.quantize", "bench.glue.pad"))
    return 1e3 * glue / prefills if glue > 0 else None
