"""Shared-prefix KV reuse: content-hashed prefix cache for the serving
engine (counterpart of ``repro/serving/prefix.py``).

At millions-of-users scale most requests open with the same system
prompt. Prefill is the expensive phase (O(P) tokens through the whole
stack vs O(1) per decode step), so re-running it per request for an
identical prefix is pure waste: the prefix KV is a deterministic
function of the prefix tokens and the params, so it can be computed once
and inserted into any later request's slot.

Two entry kinds live in one LRU:

  * ``full``   — a complete prompt's padded prefill KV plus its greedy
    first token. An exact-match hit skips prefill entirely (works in
    both chunked and single-shot prefill modes).
  * ``prefix`` — the KV of a shared prefix (``Request.shared_prefix_len``
    marks the boundary). A hit seeds the chunked-prefill scratch and
    only the request's tail runs through the model. Requires chunked
    prefill: tail resume is a ``prefill_chunk`` call at an arbitrary
    start offset.

Keys are sha256 over the raw token bytes — params identity is implicit
because each :class:`~repro_torch.serving.engine.ServingEngine` owns its
own cache (one engine == one params/cfg/geometry tuple, so entries can
never leak across models). Hit ≡ miss token equality is exact: prefill is
deterministic, so the cached KV is bit-identical to what a fresh run
would produce (tested). The port writes KV caches in place, so an entry
never aliases a tensor that a later chunk writes: the engine clones the
scratch into a ``prefix`` entry, and clones an entry into a new scratch
before resuming on it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from hashlib import sha256
from typing import Any, Dict, Optional

import numpy as np


def token_key(tokens) -> str:
    """Content hash of a token sequence (int32 bytes)."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return sha256(arr.tobytes()).hexdigest()


@dataclasses.dataclass
class Prefix:
    """Result of ``ServingEngine.prefill``: everything ``insert`` needs.

    ``kv`` holds ``{"k", "v"}`` tensors of shape (L, 1, P, kv, hd) — the
    request's prefill KV right-padded to the engine's ``prompt_pad`` (in
    the engine's prefill dtype; ``insert`` masks positions >= ``length``
    and casts to the slot-cache dtype as it writes the slot's row).
    """

    length: int                  # true prompt length
    first_token: int             # greedy token at the prompt end
    kv: Dict[str, Any]           # {"k","v"}: (L, 1, P, kv, hd)
    key: str                     # content hash of the full prompt
    from_cache: bool = False     # True when served from the prefix cache


@dataclasses.dataclass
class PrefixEntry:
    """One cached KV block: a full prompt or a shared prefix."""

    kind: str                    # "full" | "prefix"
    length: int                  # valid positions in ``kv``
    kv: Dict[str, Any]           # {"k","v"}: (L, 1, P, kv, hd)
    first_token: Optional[int] = None   # set for kind == "full"


class PrefixCache:
    """Bounded LRU of :class:`PrefixEntry` keyed by content hash."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, key: str) -> Optional[PrefixEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: str, entry: PrefixEntry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def invalidate_all(self) -> int:
        """Drop every entry (the params changed under the cache — e.g. a
        quarantined plan was re-programmed). Cached KV is a function of
        (tokens, params), so any params mutation makes all entries stale.
        Returns the number of entries dropped."""
        n = len(self._entries)
        self._entries.clear()
        self.invalidations += n
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries), "capacity": self.capacity,
                "invalidations": self.invalidations}
