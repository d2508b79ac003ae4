"""Deterministic synthetic data (counterpart of ``repro/data/pipeline.py``,
copied unchanged: it is numpy only, so the same seed gives the same
arrays in both packages).

LM batches are a pure function of (seed, step, shard): a structured
synthetic language (an n-gram successor table plus 10% noise) so that
cross-entropy falls during training, and the iterator's state is one
integer (the step) stored in the training checkpoint. CNN data is a
separable synthetic image task.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    vocab_size: int = 128
    seq_len: int = 128
    global_batch: int = 8
    num_shards: int = 1
    shard_id: int = 0
    ngram_order: int = 3     # structure strength of the synthetic language


def _ngram_table(rng: np.random.Generator, vocab: int, order: int
                 ) -> np.ndarray:
    """Deterministic successor table: next = table[prev] with noise."""
    return rng.integers(0, vocab, size=(vocab,), dtype=np.int32)


def synthetic_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """(local_batch, seq_len+1) int32; pure function of (seed, step, shard)."""
    local = cfg.global_batch // cfg.num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
    table_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7]))
    table = _ngram_table(table_rng, cfg.vocab_size, cfg.ngram_order)
    toks = np.empty((local, cfg.seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, size=(local,))
    noise = rng.random((local, cfg.seq_len)) < 0.1
    rand = rng.integers(0, cfg.vocab_size, size=(local, cfg.seq_len))
    for t in range(cfg.seq_len):
        nxt = table[toks[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return toks


def lm_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int
             ) -> Dict[str, np.ndarray]:
    """Batch dict for any assigned architecture (modality stubs included)."""
    toks = synthetic_tokens(cfg, step)
    batch: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1],
        "targets": toks[:, 1:],
    }
    local = toks.shape[0]
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_id, 11]))
    if model_cfg.vision_tokens:
        batch["patches"] = rng.standard_normal(
            (local, model_cfg.vision_tokens, model_cfg.vision_dim)
        ).astype(np.float32)
    if model_cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (local, cfg.seq_len, model_cfg.d_model)).astype(np.float32)
    return batch


class LMDataIterator:
    """Checkpointable iterator: state == step count."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 start_step: int = 0):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = lm_batch(self.cfg, self.model_cfg, self.step)
        self.step += 1
        return batch

    def state(self) -> int:
        return self.step

    def restore(self, step: int) -> None:
        self.step = step


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
