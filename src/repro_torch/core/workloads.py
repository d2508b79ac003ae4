"""CNN workload descriptors for the paper's evaluation models (Table II).

Layer-by-layer (conv / dense) shape specs for:
  ResNet18    @ CIFAR-100  (32×32)   ~11.6 M params
  InceptionV2 @ SVHN       (32×32)   ~2.66 M params (paper's slim variant)
  MobileNet   @ CIFAR-10   (32×32)   ~4.2 M params
  SqueezeNet  @ STL-10     (96×96)   ~1.16 M params
  VGG16       @ Imagenette (224×224) ~134.3 M params

These specs drive the port's CNN executor in ``repro_torch.models.cnn``
(the builders accept a width multiplier for reduced smoke/test configs).
The specs are copied unchanged from ``repro/core/workloads.py``: the port
imports nothing from the JAX package, whose ``core`` package imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    in_h: int
    in_w: int
    in_c: int
    out_c: int
    kh: int
    kw: int
    stride: int = 1
    groups: int = 1          # == in_c for depthwise
    residual_add: bool = False

    @property
    def out_h(self) -> int:
        return (self.in_h + self.stride - 1) // self.stride

    @property
    def out_w(self) -> int:
        return (self.in_w + self.stride - 1) // self.stride

    @property
    def in_c_per_group(self) -> int:
        return self.in_c // self.groups

    @property
    def macs(self) -> int:
        return (self.out_h * self.out_w * self.out_c *
                self.kh * self.kw * self.in_c_per_group)

    @property
    def weight_count(self) -> int:
        return self.out_c * self.kh * self.kw * self.in_c_per_group

    @property
    def out_elems(self) -> int:
        return self.out_h * self.out_w * self.out_c


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    name: str
    in_features: int
    out_features: int

    @property
    def macs(self) -> int:
        return self.in_features * self.out_features

    @property
    def weight_count(self) -> int:
        return self.in_features * self.out_features

    @property
    def out_elems(self) -> int:
        return self.out_features


LayerSpec = Union[ConvSpec, DenseSpec]


def total_params(layers: Sequence[LayerSpec]) -> int:
    return sum(l.weight_count for l in layers)


def total_macs(layers: Sequence[LayerSpec]) -> int:
    return sum(l.macs for l in layers)


# ---------------------------------------------------------------------------
# ResNet18 (CIFAR variant: 3x3 stem, 4 stages x 2 basic blocks)
# ---------------------------------------------------------------------------
def resnet18(num_classes: int = 100, hw: int = 32, width: float = 1.0
             ) -> List[LayerSpec]:
    def c(ch):
        return max(8, int(ch * width))
    layers: List[LayerSpec] = []
    layers.append(ConvSpec("stem", hw, hw, 3, c(64), 3, 3))
    h = hw
    in_c = c(64)
    for stage, (ch, blocks) in enumerate([(64, 2), (128, 2), (256, 2),
                                          (512, 2)]):
        ch = c(ch)
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            layers.append(ConvSpec(f"s{stage}b{b}c1", h, h, in_c, ch, 3, 3,
                                   stride=stride))
            h2 = (h + stride - 1) // stride
            layers.append(ConvSpec(f"s{stage}b{b}c2", h2, h2, ch, ch, 3, 3,
                                   residual_add=True))
            if stride != 1 or in_c != ch:
                layers.append(ConvSpec(f"s{stage}b{b}ds", h, h, in_c, ch, 1, 1,
                                       stride=stride))
            h, in_c = h2, ch
    layers.append(DenseSpec("fc", in_c, num_classes))
    return layers


# ---------------------------------------------------------------------------
# InceptionV2-slim (paper variant, ~2.66M params @ 32x32 / 10 classes).
# Inception blocks: 1x1 / 1x1->3x3 / 1x1->3x3->3x3 / pool->1x1 branches —
# deliberately 1x1-heavy and *sequential*, the property §V.C highlights.
# ---------------------------------------------------------------------------
def _inception_block(layers: List[LayerSpec], tag: str, h: int, in_c: int,
                     b1: int, b3r: int, b3: int, b5r: int, b5: int,
                     bp: int) -> int:
    layers.append(ConvSpec(f"{tag}.b1", h, h, in_c, b1, 1, 1))
    layers.append(ConvSpec(f"{tag}.b3r", h, h, in_c, b3r, 1, 1))
    layers.append(ConvSpec(f"{tag}.b3", h, h, b3r, b3, 3, 3))
    layers.append(ConvSpec(f"{tag}.b5r", h, h, in_c, b5r, 1, 1))
    layers.append(ConvSpec(f"{tag}.b5a", h, h, b5r, b5, 3, 3))
    layers.append(ConvSpec(f"{tag}.b5b", h, h, b5, b5, 3, 3))
    layers.append(ConvSpec(f"{tag}.bp", h, h, in_c, bp, 1, 1))
    return b1 + b3 + b5 + bp


def inceptionv2(num_classes: int = 10, hw: int = 32, width: float = 1.3
                ) -> List[LayerSpec]:
    # Width 1.3 + the 2048-unit dense head reproduces the paper's
    # 2.66M-param variant (InceptionV2's original classifier head is
    # similarly parameter-heavy: 1024x1000).
    def c(ch):
        return max(4, int(ch * width))
    layers: List[LayerSpec] = []
    layers.append(ConvSpec("stem1", hw, hw, 3, c(32), 3, 3, stride=1))
    layers.append(ConvSpec("stem2", hw, hw, c(32), c(64), 3, 3, stride=2))
    h, in_c = hw // 2, c(64)
    in_c = _inception_block(layers, "i3a", h, in_c, c(32), c(48), c(64),
                            c(8), c(16), c(16))
    in_c = _inception_block(layers, "i3b", h, in_c, c(64), c(64), c(96),
                            c(16), c(32), c(32))
    h = h // 2  # maxpool
    in_c = _inception_block(layers, "i4a", h, in_c, c(96), c(64), c(128),
                            c(16), c(32), c(48))
    in_c = _inception_block(layers, "i4b", h, in_c, c(112), c(72), c(160),
                            c(24), c(48), c(48))
    h = h // 2  # maxpool
    in_c = _inception_block(layers, "i5a", h, in_c, c(160), c(96), c(192),
                            c(24), c(48), c(64))
    layers.append(DenseSpec("fc1", in_c, 2048))
    layers.append(DenseSpec("fc2", 2048, num_classes))
    return layers


# ---------------------------------------------------------------------------
# MobileNet v1 (depthwise-separable; 32x32 variant: stem stride 1)
# ---------------------------------------------------------------------------
def mobilenet(num_classes: int = 10, hw: int = 32, width: float = 1.0
              ) -> List[LayerSpec]:
    def c(ch):
        return max(8, int(ch * width))
    cfg: List[Tuple[int, int]] = [  # (out_c, stride) for each separable block
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1)]
    layers: List[LayerSpec] = []
    layers.append(ConvSpec("stem", hw, hw, 3, c(32), 3, 3, stride=1))
    h, in_c = hw, c(32)
    for i, (ch, s) in enumerate(cfg):
        ch = c(ch)
        layers.append(ConvSpec(f"dw{i}", h, h, in_c, in_c, 3, 3, stride=s,
                               groups=in_c))
        h = (h + s - 1) // s
        layers.append(ConvSpec(f"pw{i}", h, h, in_c, ch, 1, 1))
        in_c = ch
    layers.append(DenseSpec("fc", in_c, num_classes))
    return layers


# ---------------------------------------------------------------------------
# SqueezeNet 1.1 (fire modules) @ 96x96
# ---------------------------------------------------------------------------
def squeezenet(num_classes: int = 10, hw: int = 96, width: float = 1.0
               ) -> List[LayerSpec]:
    def c(ch):
        return max(4, int(ch * width))
    layers: List[LayerSpec] = []
    layers.append(ConvSpec("stem", hw, hw, 3, c(64), 3, 3, stride=2))
    h, in_c = hw // 2, c(64)
    h = h // 2  # maxpool

    def fire(tag, h, in_c, squeeze, expand):
        layers.append(ConvSpec(f"{tag}.sq", h, h, in_c, c(squeeze), 1, 1))
        layers.append(ConvSpec(f"{tag}.e1", h, h, c(squeeze), c(expand), 1, 1))
        layers.append(ConvSpec(f"{tag}.e3", h, h, c(squeeze), c(expand), 3, 3))
        return 2 * c(expand)

    in_c = fire("f2", h, in_c, 16, 64)
    in_c = fire("f3", h, in_c, 16, 64)
    h = h // 2
    in_c = fire("f4", h, in_c, 32, 128)
    in_c = fire("f5", h, in_c, 32, 128)
    h = h // 2
    in_c = fire("f6", h, in_c, 48, 192)
    in_c = fire("f7", h, in_c, 48, 192)
    in_c = fire("f8", h, in_c, 64, 256)
    in_c = fire("f9", h, in_c, 64, 256)
    layers.append(ConvSpec("conv10", h, h, in_c, num_classes, 1, 1))
    return layers


# ---------------------------------------------------------------------------
# VGG16 @ 224x224 (Imagenette, 10 classes -> 134.3M params as in Table II)
# ---------------------------------------------------------------------------
def vgg16(num_classes: int = 10, hw: int = 224, width: float = 1.0
          ) -> List[LayerSpec]:
    def c(ch):
        return max(8, int(ch * width))
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    layers: List[LayerSpec] = []
    h, in_c = hw, 3
    for stage, (ch, n) in enumerate(plan):
        ch = c(ch)
        for i in range(n):
            layers.append(ConvSpec(f"s{stage}c{i}", h, h, in_c, ch, 3, 3))
            in_c = ch
        h = h // 2  # maxpool
    flat = in_c * h * h
    layers.append(DenseSpec("fc1", flat, c(4096)))
    layers.append(DenseSpec("fc2", c(4096), c(4096)))
    layers.append(DenseSpec("fc3", c(4096), num_classes))
    return layers


WORKLOADS = {
    "resnet18": lambda: resnet18(100, 32),
    "inceptionv2": lambda: inceptionv2(10, 32),
    "mobilenet": lambda: mobilenet(10, 32),
    "squeezenet": lambda: squeezenet(10, 96),
    "vgg16": lambda: vgg16(10, 224),
}

# Table II reference parameter counts (for validation)
TABLE2_PARAMS = {
    "resnet18": 11_584_865,
    "inceptionv2": 2_661_960,
    "mobilenet": 4_209_088,
    "squeezenet": 1_159_848,
    "vgg16": 134_268_738,
}

# Builders whose parameter counts Table II actually reports. MobileNet and
# SqueezeNet counts in the paper correspond to the original 1000-class heads
# (MobileNet matches 4,209,088 EXACTLY at 1000 classes), while the runtime
# workloads above use the dataset heads.
TABLE2_PARAM_BUILDERS = {
    "resnet18": lambda: resnet18(100, 32),
    "inceptionv2": lambda: inceptionv2(10, 32),
    "mobilenet": lambda: mobilenet(1000, 32),
    "squeezenet": lambda: squeezenet(1000, 96),
    "vgg16": lambda: vgg16(10, 224),
}
