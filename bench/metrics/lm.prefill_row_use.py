"""lm.prefill_row_use: prompt tokens over the rows the whole prefills ran
(each pads its prompt to the mix's ``prompt_pad``), over the prefills
whose first token came in the window outside the profiled stretch."""
from bench import yardstick


def read(ctx):
    w = ctx["window"]
    rows = w["prefills"] * w["prompt_pad"]
    return yardstick.share(w["prompt_tokens"], rows) if rows else None
