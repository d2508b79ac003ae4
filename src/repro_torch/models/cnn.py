"""CNN models built from the Table-II layer specs (counterpart of
``repro/models/cnn.py``), executed through the PIM engine: convolutions
are im2col matmuls (NHWC, patch order (kh, kw, C)) and dense layers are
matmuls, every one driven past a programmed plan — the paper's
deployment path. Also a float forward and a fake-quantized forward.

The executor is structure-aware, keyed on the builders' layer names:
ResNet basic blocks (c1/c2/ds + residual), Inception branches
(b1 | b3r->b3 | b5r->b5a->b5b | pool->bp, concatenated), SqueezeNet fire
modules (sq -> e1 || e3), MobileNet/VGG sequential. Pooling between stages
is inferred from the specs' spatial bookkeeping: when a layer expects a
smaller input than the current map, a max-pool bridges the gap. A dense
head whose input width is not the flattened map takes the spatial mean
(as the reference does — for VGG16 at 224x224 the reference's last-stage
pool is never bridged before the flatten head).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import engine
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import ConvSpec, DenseSpec, LayerSpec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.quant.quantize import fake_quantize

Params = Dict[str, Any]


def init_cnn(layers: Sequence[LayerSpec], generator: torch.Generator,
             device=None) -> Params:
    """He-normal conv weights (kh, kw, cin/groups, cout) and
    1/sqrt(fan_in) dense weights (in, out), zero biases. The draws come
    from ``generator`` on the CPU and are then moved to ``device``
    (``None`` -> CUDA)."""
    dev = resolve_device(device)
    params: Params = {}
    for spec in layers:
        if isinstance(spec, ConvSpec):
            fan_in = spec.kh * spec.kw * spec.in_c_per_group
            w = torch.randn((spec.kh, spec.kw, spec.in_c_per_group,
                             spec.out_c), generator=generator)
            w = w * (2.0 / fan_in) ** 0.5
            b = torch.zeros((spec.out_c,))
        else:
            w = torch.randn((spec.in_features, spec.out_features),
                            generator=generator)
            w = w / spec.in_features ** 0.5
            b = torch.zeros((spec.out_features,))
        params[spec.name] = {"w": w.to(dev), "b": b.to(dev)}
    return params


def _im2col(x: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, oh, ow, kh*kw*C), SAME padding,
    patch order (kh, kw, C)."""
    kh, kw, s = spec.kh, spec.kw, spec.stride
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    oh, ow = spec.out_h, spec.out_w
    cols = [x[:, i:i + oh * s:s, j:j + ow * s:s, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def _maxpool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """VALID max-pool with window = stride = ``factor`` over NHWC."""
    b, h, w, c = x.shape
    oh, ow = h // factor, w // factor
    x = x[:, :oh * factor, :ow * factor, :]
    return x.reshape(b, oh, factor, ow, factor, c).amax(dim=(2, 4))


def _avgpool3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool over NHWC (zero padding counted)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    total = sum(xp[:, i:i + h, j:j + w, :] for i in range(3)
                for j in range(3))
    return total / 9.0


class _Executor:
    """Structure-aware layer executor.

    With ``pim`` set, every layer's weights are programmed once per
    executor through :func:`repro_torch.engine.program` (keyed on the
    layer name) unless ``plans`` already holds them, and every matmul
    drives activations past the stationary plan via
    :func:`repro_torch.engine.matmul`, with the layer bias fused into the
    kernel's dequant epilogue.

    ``rng`` (a CPU ``torch.Generator``) keys the analog substrates'
    noise: one 31-bit base seed is drawn from it per forward, and every
    layer gets its own generator seeded with that base XOR the CRC-32 of
    its name, so same-shaped layers draw independent noise and the same
    generator state gives the same logits. (The seed stays within 32
    bits: PyTorch's CPU generator keeps only the low 32 bits of a seed.)
    """

    def __init__(self, params: Params, quant_bits: int = 0,
                 pim: Optional[PimConfig] = None,
                 plans: Optional[Dict[str, Any]] = None,
                 rng: Optional[torch.Generator] = None):
        self.params = params
        self.quant_bits = quant_bits
        self.pim = pim
        self._plans: Dict[str, Any] = {} if plans is None else plans
        self._rng_base = None if rng is None else int(
            torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                          device="cpu"))

    def _plan(self, name: str, w: torch.Tensor, depthwise: bool = False):
        plan = self._plans.get(name)
        if plan is None:
            plan = engine.program(w, self.pim,
                                  kind="depthwise" if depthwise else "dense")
            self._plans[name] = plan
        return plan

    def _layer_rng(self, name: str) -> Optional[torch.Generator]:
        if self._rng_base is None:
            return None
        return torch.Generator().manual_seed(
            self._rng_base ^ zlib.crc32(name.encode()))

    def matmul(self, x: torch.Tensor, w: torch.Tensor, per_col_axis,
               name: str, bias: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        if self.quant_bits:
            w = fake_quantize(w, self.quant_bits, axis=per_col_axis)
        if self.pim is not None:
            return engine.matmul(x, self._plan(name, w), cfg=self.pim,
                                 bias=bias, rng=self._layer_rng(name))
        y = x @ w
        return y if bias is None else y + bias

    def conv(self, spec: ConvSpec, x: torch.Tensor, relu: bool = True
             ) -> torch.Tensor:
        if x.shape[1] > spec.in_h:                 # stage pooling bridge
            x = _maxpool(x, x.shape[1] // spec.in_h)
        p = self.params[spec.name]
        cols = _im2col(x, spec)
        if spec.groups == 1:
            y = self.matmul(cols, p["w"].reshape(-1, spec.out_c), (0,),
                            spec.name, bias=p["b"])
        else:                                      # depthwise
            b, oh, ow, _ = cols.shape
            cols = cols.reshape(b, oh, ow, spec.kh * spec.kw, spec.in_c)
            w = p["w"].reshape(spec.kh * spec.kw, spec.in_c)
            if self.quant_bits:
                w = fake_quantize(w, self.quant_bits, axis=(0,))
            if self.pim is not None:
                y = engine.matmul(cols,
                                  self._plan(spec.name, w, depthwise=True),
                                  cfg=self.pim)
            else:
                y = torch.einsum("bhwkc,kc->bhwc", cols, w)
            y = y + p["b"]
        return torch.relu(y) if relu else y

    def dense(self, spec: DenseSpec, x: torch.Tensor, relu: bool
              ) -> torch.Tensor:
        if x.dim() == 4:
            if spec.in_features == x.shape[1] * x.shape[2] * x.shape[3]:
                x = x.reshape(x.shape[0], -1)
            else:
                x = x.mean(dim=(1, 2))
        p = self.params[spec.name]
        y = self.matmul(x, p["w"], (0,), spec.name, bias=p["b"])
        return torch.relu(y) if relu else y


def plan_cnn_weights(params: Params, layers: Sequence[LayerSpec],
                     pim: PimConfig) -> Dict[str, Any]:
    """Program every layer's weights into plans once (on the weights'
    device). Pass the result as ``cnn_forward(..., plans=...)`` so that
    repeated forwards drive activations past stationary planes. Only
    valid while ``quant_bits == 0`` (plans capture the raw weights)."""
    plans: Dict[str, Any] = {}
    for spec in layers:
        p = params[spec.name]
        if isinstance(spec, ConvSpec) and spec.groups != 1:
            w = p["w"].reshape(spec.kh * spec.kw, spec.in_c)
            plans[spec.name] = engine.program(w, pim, kind="depthwise")
        elif isinstance(spec, ConvSpec):
            plans[spec.name] = engine.program(
                p["w"].reshape(-1, spec.out_c), pim)
        else:
            plans[spec.name] = engine.program(p["w"], pim)
    return plans


def cnn_forward(params: Params, layers: Sequence[LayerSpec], x: torch.Tensor,
                quant_bits: int = 0, pim: Optional[PimConfig] = None,
                rng: Optional[torch.Generator] = None,
                plans: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC float -> logits (B, classes). ``rng``, a CPU
    ``torch.Generator``, turns on the analog substrates' noise."""
    if plans is not None and quant_bits:
        raise ValueError("precomputed plans capture raw float weights; they "
                         "cannot honor quant_bits — pass one or the other")
    ex = _Executor(params, quant_bits, pim, plans, rng)
    specs = list(layers)
    i = 0
    while i < len(specs):
        spec = specs[i]
        name = spec.name
        if isinstance(spec, ConvSpec) and name.endswith(".b1"):
            # Inception block: 7 consecutive specs
            b1s, b3rs, b3s, b5rs, b5as, b5bs, bps = specs[i:i + 7]
            if x.shape[1] > b1s.in_h:
                x = _maxpool(x, x.shape[1] // b1s.in_h)
            b1 = ex.conv(b1s, x)
            b3 = ex.conv(b3s, ex.conv(b3rs, x))
            b5 = ex.conv(b5bs, ex.conv(b5as, ex.conv(b5rs, x)))
            bp = ex.conv(bps, _avgpool3_same(x))
            x = torch.cat([b1, b3, b5, bp], dim=-1)
            i += 7
        elif isinstance(spec, ConvSpec) and name.endswith(".sq"):
            # SqueezeNet fire module: sq -> (e1 || e3) concat
            sqs, e1s, e3s = specs[i:i + 3]
            if x.shape[1] > sqs.in_h:
                x = _maxpool(x, x.shape[1] // sqs.in_h)
            sq = ex.conv(sqs, x)
            x = torch.cat([ex.conv(e1s, sq), ex.conv(e3s, sq)], dim=-1)
            i += 3
        elif isinstance(spec, ConvSpec) and name.endswith("c1") and \
                "b" in name:
            # ResNet basic block: c1 -> c2 (+ds shortcut), residual add
            c1s, c2s = specs[i], specs[i + 1]
            has_ds = i + 2 < len(specs) and specs[i + 2].name.endswith("ds")
            h = ex.conv(c2s, ex.conv(c1s, x), relu=False)
            shortcut = ex.conv(specs[i + 2], x, relu=False) if has_ds else x
            x = torch.relu(h + shortcut)
            i += 3 if has_ds else 2
        elif isinstance(spec, ConvSpec):
            last = (i == len(specs) - 1)           # SqueezeNet conv10 head
            x = ex.conv(spec, x, relu=not last)
            i += 1
        else:
            last = (i == len(specs) - 1)
            x = ex.dense(spec, x, relu=not last)
            i += 1
    if x.dim() == 4:
        x = x.mean(dim=(1, 2))
    return x
