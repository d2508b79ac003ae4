"""lm.b1_small_m_roofline: B1's small-M route (decode, M <= 64) against its
roofline over the traced stretch: least times from the launches' recorded
shapes over the route's device time."""
from bench import b1

SPANS = [b1.SPAN]


def read(ctx):
    routes = b1.by_route(ctx["trace"])
    if routes is None or "small_m" not in routes:
        return None
    return b1.roofline(*routes["small_m"])
