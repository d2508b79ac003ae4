"""Table II (scaled) and the ADC ablation on the port (counterpart of
``repro/benchmarks_impl/table2.py``).

The paper trains 5 CNNs on real datasets and reports fp32/int8/int4
accuracies. As in the reference, the claim the table supports —
quantization-induced accuracy ordering and magnitude, and that OPIMA's
PIM datapath preserves the quantized model's accuracy — is reproduced on
reduced CNNs trained on a synthetic separable image task. Training is a
plain float forward under autograd (no kernels, not through the PIM
route); the PIM rows run the engine: ``exact-cuda`` and the analog
readout route ``analog-cuda`` (a 5-bit ADC plus transmission noise keyed
by a CPU generator of seed 9).

Everything runs on the card unless ``device`` names another.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import resnet18, squeezenet
from repro_torch.data.pipeline import synthetic_images
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.cnn import cnn_forward, init_cnn

Row = Tuple[str, float, str]

# The reference's reduced model set: ResNet18 and SqueezeNet cover the
# regular-conv and fire/1x1 regimes (MobileNet does not train at toy
# scale without batch-norm).
MODELS = {
    "resnet18": (lambda: resnet18(8, 16, width=0.25), 16, 60),
    "squeezenet": (lambda: squeezenet(8, 32, width=0.5), 32, 80),
}
NOISE = 0.8
NOISE_SEED = 9


def _train(layers, params, x: torch.Tensor, y: torch.Tensor,
           steps: int = 60, lr: float = 0.05):
    """Clipped-gradient SGD on the float forward: each step takes 32
    samples (``default_rng(step)``'s permutation, as the reference does),
    and the update is ``w - lr * g / max(|g|, 1)``."""
    params = {name: {k: v.detach().clone().requires_grad_(True)
                     for k, v in p.items()} for name, p in params.items()}
    leaves = [v for p in params.values() for v in p.values()]
    n = x.shape[0]
    for i in range(steps):
        idx = torch.from_numpy(np.random.default_rng(i).permutation(n)[:32])
        idx = idx.to(x.device)
        logits = cnn_forward(params, layers, x[idx])
        tgt = logits.gather(1, y[idx].long()[:, None])[:, 0]
        loss = (torch.logsumexp(logits, dim=-1) - tgt).mean()
        grads = torch.autograd.grad(loss, leaves)
        gn = torch.sqrt(sum((g * g).sum() for g in grads))
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w -= lr * g / torch.clamp_min(gn, 1.0)
    return {name: {k: v.detach() for k, v in p.items()}
            for name, p in params.items()}


@torch.no_grad()
def _acc(params, layers, x, y, quant_bits: int = 0,
         pim: Optional[PimConfig] = None,
         rng: Optional[torch.Generator] = None) -> float:
    logits = cnn_forward(params, layers, x, quant_bits=quant_bits, pim=pim,
                         rng=rng)
    return float((logits.argmax(-1) == y).float().mean())


def _data(hw: int, n_test: int, device):
    xtr, ytr = synthetic_images(0, 192, hw, 8, noise=NOISE)
    xte, yte = synthetic_images(1, n_test, hw, 8, noise=NOISE)
    return [torch.from_numpy(v).to(device) for v in (xtr, ytr, xte, yte)]


def _pim(substrate: str, adc_bits: int = 5) -> PimConfig:
    return PimConfig(weight_bits=4, act_bits=4, adc_bits=adc_bits,
                     substrate=substrate)


def run_table2(device=None) -> List[Row]:
    dev = resolve_device(device)
    rows: List[Row] = []
    for name, (build, hw, steps) in MODELS.items():
        layers = build()
        xtr, ytr, xte, yte = _data(hw, 96, dev)
        params = init_cnn(layers, torch.Generator().manual_seed(0),
                          device=dev)
        params = _train(layers, params, xtr, ytr, steps=steps)
        a_fp = _acc(params, layers, xte, yte)
        a_i8 = _acc(params, layers, xte, yte, quant_bits=8)
        a_i4 = _acc(params, layers, xte, yte, quant_bits=4)
        # the PIM rows use the reference's 48-image subset
        xs, ys = xte[:48], yte[:48]
        a_pim = _acc(params, layers, xs, ys, pim=_pim("exact-cuda"))
        a_pim_analog = _acc(params, layers, xs, ys, pim=_pim("analog-cuda"),
                            rng=torch.Generator().manual_seed(NOISE_SEED))
        rows += [
            (f"table2.{name}.acc_fp32", a_fp, ""),
            (f"table2.{name}.acc_int8", a_i8,
             f"drop {a_fp - a_i8:+.3f} (paper: ~1%)"),
            (f"table2.{name}.acc_int4", a_i4,
             f"drop {a_fp - a_i4:+.3f} (paper: <=6%)"),
            (f"table2.{name}.acc_pim_int4", a_pim,
             f"vs int4 {a_pim - a_i4:+.3f} (exact datapath)"),
            (f"table2.{name}.acc_pim_analog5b", a_pim_analog,
             f"vs int4 {a_pim_analog - a_i4:+.3f} (5-bit ADC + noise)"),
        ]
    return rows


def run_adc_ablation(device=None) -> List[Row]:
    """Beyond-paper ablation: analog-readout accuracy against ADC
    resolution, with the same noise model as everywhere else."""
    dev = resolve_device(device)
    name = "resnet18"
    build, hw, steps = MODELS[name]
    layers = build()
    xtr, ytr, xte, yte = _data(hw, 64, dev)
    params = init_cnn(layers, torch.Generator().manual_seed(0), device=dev)
    params = _train(layers, params, xtr, ytr)
    a_exact = _acc(params, layers, xte, yte, pim=_pim("exact-cuda"))
    rows: List[Row] = [(f"adc_ablation.{name}.exact", a_exact, "")]
    for adc in (3, 4, 5, 6, 8):
        a = _acc(params, layers, xte, yte, pim=_pim("analog-cuda", adc),
                 rng=torch.Generator().manual_seed(NOISE_SEED))
        rows.append((f"adc_ablation.{name}.adc{adc}b", a,
                     f"vs exact {a - a_exact:+.3f}"))
    return rows
