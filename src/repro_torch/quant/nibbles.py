"""Nibble (4-bit plane) decomposition (counterpart of
``repro/quant/nibbles.py``).

OPIMA stores 4 bits per OPCM cell, so a b-bit code occupies ceil(b/4)
cells and a b_a x b_w multiply runs as (b_a/4)(b_w/4) one-shot 4b x 4b
products recombined by shift-and-add. The decomposition is sign-magnitude:
unsigned base-16 digits of the magnitude, each carrying the code's sign,

    value = sum_d (sign * magnitude_digit_d) * 16**d,

so every digit lies in [-15, 15] and fits an OPCM cell's 16 levels.
"""
from __future__ import annotations

from typing import Tuple

import torch

NIBBLE_BITS = 4
NIBBLE_BASE = 1 << NIBBLE_BITS  # 16


def num_nibbles(bits: int) -> int:
    return max(1, (bits + NIBBLE_BITS - 1) // NIBBLE_BITS)


def to_nibbles(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed integer codes -> int8 digit planes of shape
    ``(num_nibbles(bits),) + codes.shape``, LSB first, each in [-15, 15],
    with ``sum_d planes[d] * 16**d == codes``."""
    n = num_nibbles(bits)
    sign = torch.sign(codes).to(torch.int32)
    mag = codes.abs().to(torch.int32)
    planes = []
    for _ in range(n):
        planes.append(torch.remainder(mag, NIBBLE_BASE) * sign)
        mag = torch.div(mag, NIBBLE_BASE, rounding_mode="floor")
    return torch.stack(planes, dim=0).to(torch.int8)


def from_nibbles(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_nibbles` (shift-and-add recombination), int32."""
    n = planes.shape[0]
    weights = (NIBBLE_BASE ** torch.arange(n, dtype=torch.int32,
                                           device=planes.device)).reshape(
        (n,) + (1,) * (planes.dim() - 1))
    return torch.sum(planes.to(torch.int32) * weights, dim=0,
                     dtype=torch.int32)


def pack_nibble_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pack two unsigned 4-bit planes into one uint8 (storage density
    model: two OPCM cells per byte of host storage)."""
    return torch.bitwise_or(
        torch.bitwise_left_shift(
            torch.bitwise_and(hi.to(torch.uint8), 0xF), 4),
        torch.bitwise_and(lo.to(torch.uint8), 0xF))


def unpack_nibble_pair(packed: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.bitwise_and(packed, 0xF).to(torch.uint8)
    hi = torch.bitwise_and(torch.bitwise_right_shift(packed, 4),
                           0xF).to(torch.uint8)
    return lo, hi
