"""Readings that set a cell's correctness limits: for each seed, the
program's compared numbers and their control's (the plain reference
computed one precision lower, bfloat16 for the configuration's float32,
put in the program's place), at the cell's own size and load; for an LM
cell also the sound variants the limits must pass: the reference's table
scaled by 1 + 2**-21, its RMS norms' mean square taken as a sum, and
(``--block``) the program with another prompt attention block.

    python3 bench/control.py --workload <name> --seeds 11 12 13 --seconds 10 [--block 256]

Each seed sets the program up, serves a short window at the cell's load
(long enough to finish the mix's longest requests), then reads the
numbers over the same outputs. One JSON line per seed and variant on
standard output. The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# a rounding-sized change of the reference's table
TABLE_SCALE = 1 + 2 ** -21


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def served(workload: str, seed: int, seconds: float, device: str,
           **overrides):
    """Set up, serve ``seconds`` and release; returns the system."""
    from bench import harness
    from bench.harness import Tracer, Spans
    cell = harness.Cell(workload)
    system = cell.driver().System(cell, seed, device, log,
                                  time.perf_counter(), **overrides)
    system.setup()
    system.window(seconds, Tracer(False, Spans([])))
    system.release()
    return system


def readings(workload: str, seed: int, seconds: float, block: int = 0,
             device: str = "cuda"):
    """The JSON lines of one seed: the program with its control, and for
    an LM cell the sound variants."""
    system = served(workload, seed, seconds, device)
    out = dict(system.readings(control=True), workload=workload, seed=seed,
               variant="program")
    yield out
    if system.cell.config["driver"] != "lm":
        return
    yield dict(system.readings(table_scale=TABLE_SCALE), workload=workload,
               seed=seed, variant=f"table x {TABLE_SCALE!r}")
    yield dict(system.readings(norm_by_sum=True), workload=workload,
               seed=seed, variant="RMS norms by sum")
    if block:
        del system
        system = served(workload, seed, seconds, device, attn_block=block)
        yield dict(system.readings(), workload=workload, seed=seed,
                   variant=f"attn_block {block}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--block", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    from bench import harness
    harness.use_cache_dirs()
    for seed in args.seeds:
        for line in readings(args.workload, seed, args.seconds, args.block):
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
