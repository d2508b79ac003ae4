"""End-to-end driver (the paper's scenario) on the PyTorch port: CNN
inference executed on the simulated OPIMA PIM substrate, with accuracy +
hardware estimates (counterpart of ``examples/cnn_pim_inference.py``).

Trains a reduced ResNet18 on a synthetic image task, deploys it into
'OPCM cells' (4-bit quantization), runs inference through the bit-sliced
PIM engine (``exact-cuda``: the PIM matmul kernel; ``analog-cuda``: the
two analog readout kernels, with noise keyed by a CPU generator), and
reports the analytical OPIMA latency/energy next to the comparison
platforms (the reference's numbers).

  PYTHONPATH=src python examples/torch/cnn_pim_inference.py          # card
  PYTHONPATH=src python examples/torch/cnn_pim_inference.py --device cpu

Wall time on the card (NVIDIA H100 80GB HBM3, 700.00 W): 1.95 s for
``main()`` at its defaults in a process whose kernels were already built
(``chip_smoke.py`` phase 22); a fresh process first builds the kernels
with ``nvcc`` (about a minute).
"""
import argparse

import torch

from repro_torch.benchmarks_impl.table2 import _acc, _train
from repro_torch.core.baselines import ALL_PLATFORMS, PHPIM_MODEL
from repro_torch.core.perfmodel import network_perf, total_power_w
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import resnet18
from repro_torch.data.pipeline import synthetic_images
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.cnn import init_cnn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    layers = resnet18(8, 16, width=0.25)
    print(f"model: reduced ResNet18, "
          f"{sum(l.weight_count for l in layers):,} params")
    xtr, ytr = synthetic_images(0, 256, 16, 8, noise=0.45)
    xte, yte = synthetic_images(1, 128, 16, 8, noise=0.45)
    xtr, ytr, xte, yte = (torch.from_numpy(v).to(dev)
                          for v in (xtr, ytr, xte, yte))

    params = init_cnn(layers, torch.Generator().manual_seed(0), device=dev)
    params = _train(layers, params, xtr, ytr, steps=60)

    acc_fp = _acc(params, layers, xte, yte)
    acc_pim = _acc(params, layers, xte, yte,
                   pim=PimConfig(weight_bits=4, act_bits=4,
                                 substrate="exact-cuda"))
    acc_analog = _acc(params, layers, xte, yte,
                      pim=PimConfig(weight_bits=4, act_bits=4,
                                    substrate="analog-cuda", adc_bits=5),
                      rng=torch.Generator().manual_seed(9))
    print(f"accuracy: fp32 {acc_fp:.3f} | PIM int4 (exact) {acc_pim:.3f} | "
          f"PIM analog 5b-ADC {acc_analog:.3f}")

    # hardware-side estimate for the FULL ResNet18 (paper Fig. 9/11/12)
    full = resnet18()
    perf = network_perf("resnet18", full, weight_bits=4, act_bits=4)
    print(f"\nOPIMA @ {total_power_w():.1f} W:")
    print(f"  latency {perf.latency_s*1e3:.3f} ms "
          f"(processing {perf.processing_s*1e3:.3f} + "
          f"writeback {perf.writeback_s*1e3:.3f})")
    print(f"  {perf.fps:.0f} FPS | {perf.fps/total_power_w():.0f} FPS/W | "
          f"EPB {perf.epb()*1e12:.0f} pJ/bit")
    print("\ncomparison platforms (same workload):")
    rows = {}
    for p in ALL_PLATFORMS:
        rows[p.name] = (p.latency_s(full, 4), p.fps_per_watt(full, 4),
                        p.epb_j_per_bit())
        print(f"  {p.name:11s} {p.latency_s(full, 4)*1e3:8.3f} ms | "
              f"{p.fps_per_watt(full, 4):8.1f} FPS/W | "
              f"EPB {p.epb_j_per_bit()*1e12:7.0f} pJ/bit")
    rows["PhPIM"] = (PHPIM_MODEL.latency_s("resnet18", full),
                     PHPIM_MODEL.fps_per_watt("resnet18", full))
    print(f"  {'PhPIM':11s} "
          f"{PHPIM_MODEL.latency_s('resnet18', full)*1e3:8.3f} ms"
          f" | {PHPIM_MODEL.fps_per_watt('resnet18', full):8.1f} FPS/W")
    return {"acc_fp": acc_fp, "acc_pim": acc_pim, "acc_analog": acc_analog,
            "perf": perf, "platforms": rows}


if __name__ == "__main__":
    main()
