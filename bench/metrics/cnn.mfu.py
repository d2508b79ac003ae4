"""cnn.mfu: the whole step's share of the chip's int8 peak: 2 x the
model's multiply-accumulates per image (counted from the layer shapes) x
the images of the batches completed in the window outside the profiled
stretch, over that time, over 1,979 TOP/s (B1 computes in int8)."""
from bench import yardstick


def read(ctx):
    w = ctx["window"]
    if not w["host_images"] or w["host"].seconds <= 0:
        return None
    ops = 2.0 * w["macs_per_image"] * w["host_images"] / w["host"].seconds
    return yardstick.share(ops, yardstick.INT8_OPS_PER_S)
