"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and draws its work from the seed.

Sizes are stratified: each block of ``block`` requests holds the same
multiset of prompt and output lengths (the distribution's quantiles at
the block's midpoints), in an order drawn from the seed, so every seed
asks for the same work in another order; token ids are drawn uniformly
over the vocabulary.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def quantile_sizes(dist: Dict, n: int) -> List[int]:
    """``n`` sizes at the midpoint quantiles of ``dist``: ``uniform``
    (integers lo..hi) or ``log_uniform`` (lo..hi, log-spaced)."""
    lo, hi = dist["lo"], dist["hi"]
    qs = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "uniform":
        return [lo + min(int(q * (hi - lo + 1)), hi - lo) for q in qs]
    if dist["dist"] == "log_uniform":
        return [min(hi, max(lo, int(round(lo * (hi / lo) ** q))))
                for q in qs]
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def lm_requests(traffic: Dict, vocab: int, seed: int
                ) -> List[Tuple[np.ndarray, int]]:
    """The backlog of ``traffic["backlog"]`` requests as (prompt token
    ids, output length), in send order."""
    rng = np.random.default_rng(seed)
    block = traffic["block"]
    prompts = np.asarray(quantile_sizes(traffic["prompt"], block))
    outputs = np.asarray(quantile_sizes(traffic["output"], block))
    out = []
    for _ in range(math.ceil(traffic["backlog"] / block)):
        for p, g in zip(rng.permutation(prompts), rng.permutation(outputs)):
            toks = rng.integers(0, vocab, size=int(p), dtype=np.int64)
            out.append((toks.astype(np.int32), int(g)))
    return out[:traffic["backlog"]]
