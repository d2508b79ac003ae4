"""Synthetic CNN data (counterpart of ``synthetic_images`` in
``repro/data/pipeline.py``, copied unchanged: it is numpy only, and the
same seed gives the same images in both packages)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_images(seed: int, n: int, hw: int, classes: int,
                     noise: float = 0.35, template_seed: int = 7
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional images: each class has a fixed low-frequency
    template; samples = template + Gaussian noise. Returns NHWC float32
    images (n, hw, hw, 3) and int32 labels (n,).

    ``template_seed`` is separate from ``seed`` so train/test splits share
    the same class templates (seed only drives labels + noise)."""
    rng = np.random.default_rng(template_seed)
    sample_rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    templates = []
    for c in range(classes):
        fx, fy = rng.integers(1, 4, size=2)
        phase = rng.random(3) * 2 * np.pi
        t = np.stack([np.sin(2 * np.pi * (fx * xx + fy * yy) + p)
                      for p in phase], axis=-1)
        templates.append(t)
    templates = np.stack(templates)                       # (C, hw, hw, 3)
    labels = sample_rng.integers(0, classes, size=(n,))
    imgs = templates[labels] + noise * sample_rng.standard_normal(
        (n, hw, hw, 3)).astype(np.float32)
    return imgs.astype(np.float32), labels.astype(np.int32)
