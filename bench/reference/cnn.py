"""Plain reference of the CNN configurations: the layer table, the
weights drawn from the seed, and the forward pass with w4a4 projections.

Written from the configuration alone, with plain torch operations and the
frozen quantization semantics of :mod:`bench.reference.quant`; it imports
nothing of the program. The network is the CIFAR ResNet18 of the OPIMA
paper's Table II (arXiv:2407.08205; He et al., arXiv:1512.03385, with a
3x3 stem and no pooling before the stages): NHWC activations, SAME
padding, convolutions as patch matrices in (kh, kw, C) order, basic blocks
``relu(c2(relu(c1(x))) + shortcut(x))`` with a 1x1 strided projection
where the shape changes, no batch normalization (the model as the
repository defines it), the spatial mean before the classifier. Every
convolution and the classifier run through the quantized product: per
output column weight codes, per row activation codes, zero biases.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from bench.reference.quant import QuantWeight, qmatmul


def layer_table(model: Dict) -> List[Dict]:
    """The layers in execution order, each a dict: ``name``, ``kind``
    ("conv" or "dense"), for a convolution ``in_hw``, ``in_c``, ``out_c``,
    ``k``, ``stride``, ``role`` ("stem", "c1", "c2", "ds"); for the
    classifier ``in_f``, ``out_f``."""
    hw = model["image_hw"]
    stem = model["stem_channels"]
    layers = [dict(name="stem", kind="conv", in_hw=hw, in_c=3, out_c=stem,
                   k=3, stride=1, role="stem")]
    in_c = stem
    for s, (ch, blocks) in enumerate(model["stages"]):
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            layers.append(dict(name=f"s{s}b{b}c1", kind="conv", in_hw=hw,
                               in_c=in_c, out_c=ch, k=3, stride=stride,
                               role="c1"))
            hw2 = (hw + stride - 1) // stride
            layers.append(dict(name=f"s{s}b{b}c2", kind="conv", in_hw=hw2,
                               in_c=ch, out_c=ch, k=3, stride=1, role="c2"))
            if stride != 1 or in_c != ch:
                layers.append(dict(name=f"s{s}b{b}ds", kind="conv",
                                   in_hw=hw, in_c=in_c, out_c=ch, k=1,
                                   stride=stride, role="ds"))
            hw, in_c = hw2, ch
    layers.append(dict(name="fc", kind="dense", in_f=in_c,
                       out_f=model["num_classes"]))
    return layers


def draw_weights(layers: List[Dict], seed: int, device) -> Dict[str, Dict]:
    """He-normal convolution weights (kh, kw, C_in, C_out) and
    1/sqrt(fan_in) classifier weights (in, out), zero biases, all from one
    normal draw of a device generator seeded with ``seed``, in layer
    order. The program and the reference are handed the same tensors."""
    sizes = []
    for l in layers:
        if l["kind"] == "conv":
            sizes.append(l["k"] * l["k"] * l["in_c"] * l["out_c"])
        else:
            sizes.append(l["in_f"] * l["out_f"])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    params, at = {}, 0
    for l, n in zip(layers, sizes):
        chunk = flat[at:at + n]
        at += n
        if l["kind"] == "conv":
            fan_in = l["k"] * l["k"] * l["in_c"]
            w = chunk.reshape(l["k"], l["k"], l["in_c"], l["out_c"]) \
                * (2.0 / fan_in) ** 0.5
            b = torch.zeros((l["out_c"],), device=device)
        else:
            w = chunk.reshape(l["in_f"], l["out_f"]) / l["in_f"] ** 0.5
            b = torch.zeros((l["out_f"],), device=device)
        params[l["name"]] = {"w": w, "b": b}
    return params


def draw_images(seed: int, index: int, batch: int, hw: int, device
                ) -> torch.Tensor:
    """Batch ``index`` of the traffic: standard-normal NHWC images from a
    device generator keyed by the seed and the batch index."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index) % (2 ** 63))
    return torch.randn((batch, hw, hw, 3), generator=gen, device=device)


def _patches(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, oh, ow, k*k*C), SAME padding, (kh, kw, C)."""
    lo = (k - 1) // 2
    oh = (x.shape[1] + stride - 1) // stride
    x = F.pad(x, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    cols = [x[:, i:i + oh * stride:stride, j:j + oh * stride:stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


class Reference:
    """The quantized weights of one draw, and the forward pass. With
    ``dtype=torch.bfloat16`` every float tensor (activations, the
    dequantized products, residuals, the mean) is held in bfloat16: the
    control, the configuration's float32 one precision lower."""

    def __init__(self, layers: List[Dict], params: Dict[str, Dict],
                 bits: Dict[str, int], dtype=torch.float32):
        self.layers = layers
        self.act_bits = bits["act"]
        self.dtype = dtype
        self.q = {}
        for l in layers:
            w = params[l["name"]]["w"]
            w2 = w.reshape(-1, w.shape[-1])
            self.q[l["name"]] = (QuantWeight(w2, bits["weight"]).to(dtype),
                                 params[l["name"]]["b"].to(dtype))

    def _conv(self, l: Dict, x: torch.Tensor, relu: bool) -> torch.Tensor:
        w, b = self.q[l["name"]]
        y = qmatmul(_patches(x, l["k"], l["stride"]), w, self.act_bits, b)
        return torch.relu(y) if relu else y

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 logits (B, classes)."""
        x = images.to(self.dtype)
        i = 0
        while i < len(self.layers):
            l = self.layers[i]
            if l.get("role") == "c1":
                c2 = self.layers[i + 1]
                ds = self.layers[i + 2] if i + 2 < len(self.layers) and \
                    self.layers[i + 2].get("role") == "ds" else None
                h = self._conv(c2, self._conv(l, x, True), False)
                short = self._conv(ds, x, False) if ds is not None else x
                x = torch.relu(h + short)
                i += 3 if ds is not None else 2
            elif l["kind"] == "conv":
                x = self._conv(l, x, True)
                i += 1
            else:
                w, b = self.q[l["name"]]
                x = qmatmul(x.mean(dim=(1, 2)), w, self.act_bits, b)
                i += 1
        return x.to(torch.float32)
