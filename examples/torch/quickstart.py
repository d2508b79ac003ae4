"""Quickstart: OPIMA's datapath in five minutes, on the PyTorch port
(counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch/quickstart.py               # card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu

On the card the engine's matmuls run the hand-written kernels: the PIM
matmul on ``exact-cuda`` and the two analog readout kernels on
``analog-cuda``; on the CPU their plain versions. The analog readout's
noise is keyed by a CPU ``torch.Generator``, so its error differs from
the JAX example's (``jax.random``); every other line prints the
reference's numbers.

Wall time on the card (NVIDIA H100 80GB HBM3, 700.00 W): 0.27 s for
``main()`` at its defaults in a process whose kernels were already built
(``chip_smoke.py`` phase 22); a fresh process first builds the kernels
with ``nvcc`` (about a minute).
"""
import argparse

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core.cell import CellDesign, best_design
from repro_torch.core.perfmodel import best_grouping, network_perf, \
    total_power_w
from repro_torch.core.pim import PimConfig, reference_quantized_matmul
from repro_torch.core.workloads import resnet18
from repro_torch.kernels.runtime import resolve_device


def _randn(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. OPCM cell (paper Fig. 2) ==")
    cell = CellDesign()  # the paper's (0.48 um, 20 nm) design point
    print(f"   transmission contrast dT = {float(cell.contrast()):.3f} "
          f"(paper ~0.96) -> 16 levels -> 4 bits/cell")
    # float32 grids as the reference's jnp.arange builds them
    w = torch.from_numpy(np.arange(0.30, 0.71, 0.02, dtype=np.float32))
    t = torch.from_numpy(np.arange(10.0, 40.1, 2.5, dtype=np.float32))
    optimum = best_design(w, t)
    print(f"   swept optimum: {optimum}")

    print("== 2. The engine: program once, execute many ==")
    x = _randn((8, 256), 0, dev)
    wmat = _randn((256, 64), 1, dev)
    print(f"   substrates: {', '.join(engine.available_substrates())}")
    cfg = PimConfig(weight_bits=4, act_bits=4,      # one OPCM cell/weight
                    substrate="exact-cuda")
    plan = engine.program(wmat, cfg)                 # 'program' the cells
    y = engine.matmul(x, plan)                       # nibble MACs+shift-add
    ref = reference_quantized_matmul(x, plan, cfg)
    # repro-lint: disable=RPR101 (the demo reads its check once, to print it)
    exact = bool(torch.equal(y, ref))
    print(f"   bit-exact vs int oracle: {exact}")
    y_torch = engine.matmul(x, plan, cfg=PimConfig(substrate="exact-torch"))
    # repro-lint: disable=RPR101 (the demo reads its check once, to print it)
    twin = bool(torch.equal(y, y_torch))
    print(f"   exact-torch twin bit-identical: {twin}")
    plan_a = engine.program(wmat, PimConfig(substrate="analog-cuda",
                                            adc_bits=5))
    y_analog = engine.matmul(x, plan_a,
                             rng=torch.Generator().manual_seed(2))
    # repro-lint: disable=RPR101 (the demo reads its error once, to print it)
    rel = float(torch.linalg.norm(y_analog - ref) / torch.linalg.norm(ref))
    print(f"   analog readout (5-bit ADC + scattering noise): "
          f"rel err {rel:.3f}")

    print("== 3. Architecture-level performance (paper Figs. 7-9) ==")
    print(f"   optimal subarray grouping: {best_grouping()} (paper: 16)")
    print(f"   operating power: {total_power_w():.1f} W (paper: 55.9 W)")
    perf = network_perf("resnet18", resnet18(), weight_bits=4, act_bits=4)
    print(f"   ResNet18 int4: processing {perf.processing_s*1e6:.1f} us + "
          f"writeback {perf.writeback_s*1e6:.1f} us "
          f"= {perf.fps:.0f} FPS, {perf.fps/total_power_w():.0f} FPS/W")
    return {"contrast": float(cell.contrast()), "best_design": optimum,
            "exact": exact, "twin": twin, "analog_rel_err": rel,
            "best_grouping": best_grouping(), "power_w": total_power_w(),
            "perf": perf}


if __name__ == "__main__":
    main()
