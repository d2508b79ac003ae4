"""B1 (``csrc/pim_matmul.cu``) in a traced stretch: each launch's least
time from the shapes recorded at its call, matched in order with the
kernels the device ran, summed by route."""
from typing import Dict, Optional, Tuple

from bench import yardstick

SPAN = {"target": "repro_torch.kernels.pim_matmul.ops:pim_matmul_fused",
        "label": "bench.b1", "shapes": True}
# the kernels' names by route (templated; matched as fragments)
ROUTES = {"wgmma": "pim_matmul_wgmma_kernel",
          "mma_sync": "pim_matmul_kernel",
          "small_m": "pim_matmul_small_m_kernel"}


def by_route(trace) -> Optional[Dict[str, Tuple[float, float]]]:
    """route -> (sum of least times, sum of device times), in seconds;
    None when the stretch holds no launch or the launches do not match the
    recorded calls one for one."""
    if trace is None:
        return None
    calls = trace.calls.get(SPAN["label"], [])
    kernels = trace.kernels(tuple(ROUTES.values()))
    if not calls or len(calls) != len(kernels):
        return None
    out: Dict[str, Tuple[float, float]] = {}
    for (args, kwargs), (name, t0, t1) in zip(calls, kernels):
        route = next(r for r, frag in ROUTES.items()
                     if frag in name and (r != "mma_sync"
                                          or "wgmma" not in name))
        least = yardstick.fused_launch_bound(args[0], args[1],
                                             "bias" in kwargs)
        b, d = out.get(route, (0.0, 0.0))
        out[route] = (b + least, d + (t1 - t0))
    return out


def roofline(bound: float, took: float) -> Optional[float]:
    """The share in percent, or None without device time."""
    return yardstick.share(bound, took) if took > 0 else None
