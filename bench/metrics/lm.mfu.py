"""lm.mfu: the whole step's share of the chip's int8 peak: the model's
projection, attention and unembedding operations, counted from shapes for
the useful work done in the window outside the profiled stretch (each
prefill whose first token came then, at its prompt's length, causal; each
token decoded then, at its position), over that time, over 1,979 TOP/s
(the projections' precision)."""
from bench import yardstick


def read(ctx):
    w = ctx["window"]
    if not w["ops"] or w["host"].seconds <= 0:
        return None
    return yardstick.share(w["ops"] / w["host"].seconds,
                           yardstick.INT8_OPS_PER_S)
