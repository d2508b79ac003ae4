"""cnn.b1_roofline: B1's share of its roofline over the traced stretch:
the sum of the least time of each launch (its operands' shapes as the
kernel takes them, recorded at the call) over B1's device time."""
from bench import b1

SPANS = [b1.SPAN]


def read(ctx):
    routes = b1.by_route(ctx["trace"])
    if routes is None:
        return None
    bound = sum(r[0] for r in routes.values())
    took = sum(r[1] for r in routes.values())
    return b1.roofline(bound, took)
