"""Slot allocator + slot-indexed KV cache for continuous batching
(counterpart of ``repro/serving/slots.py``).

A *slot* is one row of a fixed-size decode batch. The slot cache is a
standard stacked-layer KV cache — built by :func:`repro_torch.models.lm.
init_cache` — whose batch axis is indexed by slot id rather than by
request. Requests come and go; the cache tensors and every step shape
stay put.

Slot lifecycle:

  1. ``SlotAllocator.alloc`` hands out a free slot id (host-side free
     list — admission decisions are scheduler policy, not device code).
  2. :func:`write_prefill` writes one request's padded prefill KV into
     the slot's row, in place, with a mask: positions beyond the true
     prompt length are zeroed, so a shorter prompt never inherits the
     previous occupant's keys inside its padded region.
  3. Decode steps append at per-slot offsets (``decode_attention`` with a
     per-row index vector); positions beyond a slot's current length are
     never attended (the validity mask is per-row) and are overwritten in
     the same step they would first become visible.
  4. ``SlotAllocator.free`` returns the slot; the next occupant's prefill
     overwrites the row.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class SlotAllocator:
    """Host-side free-list of decode slots.

    Tracks which request owns which slot so leaks are detectable: the
    scheduler asserts ``num_active == 0`` once the queue drains.
    """

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError(f"num_slots must be positive, got {num_slots}")
        self.num_slots = num_slots
        # pop() takes from the tail; reversed init hands out 0, 1, 2, ...
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._owner: Dict[int, Hashable] = {}

    def alloc(self, owner: Hashable) -> Optional[int]:
        """Claim a free slot for ``owner``; None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = owner
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not allocated")
        del self._owner[slot]
        self._free.append(slot)

    def owner(self, slot: int) -> Hashable:
        return self._owner[slot]

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return len(self._owner)

    def active_slots(self) -> List[int]:
        return sorted(self._owner)


def check_slot_compatible(cfg: ModelConfig) -> None:
    """Continuous batching covers attention-only decoders.

    SSM / hybrid states integrate every prefill position (a right-padded
    prompt would fold pad tokens into the state), and encoder / vision
    prefixes need per-request side inputs the slot cache does not carry
    yet; reject those up front instead of serving wrong tokens.
    """
    if cfg.block_type != "attn":
        raise NotImplementedError(
            f"continuous batching supports attention-only decoders; "
            f"{cfg.name} has block_type={cfg.block_type!r} (SSM state "
            "would absorb the prompt padding)")
    if cfg.encoder_layers or cfg.vision_tokens:
        raise NotImplementedError(
            f"continuous batching does not carry encoder/vision prefix "
            f"inputs yet ({cfg.name})")


def init_slot_cache(cfg: ModelConfig, num_slots: int, max_len: int,
                    dtype=torch.bfloat16, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Slot-indexed KV cache: ``lm.init_cache`` with batch = slots."""
    check_slot_compatible(cfg)
    return lm.init_cache(cfg, num_slots, max_len, dtype=dtype, device=device)


def write_prefill(slot_cache: Dict[str, torch.Tensor],
                  prefill_cache: Dict[str, torch.Tensor],
                  slot: int, length: int) -> Dict[str, torch.Tensor]:
    """Masked write of one request's padded prefill KV into its slot row,
    in place (``slot_cache`` is returned).

    ``prefill_cache`` holds (L, 1, P, kv, hd) tensors from a prompt
    right-padded to the fixed pad length P; positions >= ``length`` are
    zeroed, the rest cast to the slot cache's dtype, and positions [0, P)
    of row ``slot`` replaced. ``prefill_cache`` itself is not written.
    """
    for key in ("k", "v"):
        blk = prefill_cache[key]                       # (L, 1, P, kv, hd)
        dst = slot_cache[key]
        keep = torch.arange(blk.shape[2], device=blk.device) < length
        blk = torch.where(keep[None, None, :, None, None], blk,
                          torch.zeros((), dtype=blk.dtype,
                                      device=blk.device))
        dst[:, slot:slot + 1, :blk.shape[2]] = blk.to(dst.dtype)
    return slot_cache
