"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (loading, drawing the weights from the
seed, programming them, building and warming the kernels) starts with the
process; the window measures for ``--seconds``; then the window's outputs
are compared with the plain reference. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``checks``: each number
compared beside its limit, which also close standard error). With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window. Exits non-zero and prints no result without a CUDA device, with
fewer devices than the cell asks for, or if ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("USE_FLAX", "0")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} devices, "
            f"{torch.cuda.device_count()} found")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        log(f"the program under test is missing: {err}")
        return 2
    harness.use_cache_dirs()
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         log=log, t0=T0)
    found = harness.forbidden_modules()
    if found:
        log("forbidden modules loaded in the measured process: "
            + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
