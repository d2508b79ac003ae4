"""lm.device_idle_share: the share of the traced stretch (first to last
device activity) in which no operation ran on the device."""
from bench import yardstick


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return yardstick.share(t.window_s - t.busy_s, t.window_s)
