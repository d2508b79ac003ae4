"""lm.attention_ms_per_prefill: device time of the prefill's attention
(scores, softmax and the weighted values; full or blockwise) per prefill
of the traced stretch."""
SPANS = [
    {"target": "repro_torch.models.attention:full_attention",
     "label": "bench.attention"},
    {"target": "repro_torch.models.attention:blockwise_attention",
     "label": "bench.attention"},
    {"target": "repro_torch.serving.engine:ServingEngine._prefill_fn",
     "label": "bench.prefill"},
]


def read(ctx):
    t = ctx["trace"]
    prefills = t.range_count("bench.prefill") if t is not None else 0
    if not prefills:
        return None
    attn = t.range_device_s("bench.attention", within="bench.prefill")
    return 1e3 * attn / prefills if attn > 0 else None
