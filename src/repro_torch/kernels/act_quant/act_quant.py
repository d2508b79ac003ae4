"""Launch wrapper for the fused activation quantizer
(``repro_torch/csrc/act_quant.cu``).

One launch turns float32 or bfloat16 rows (M, K) on the card into their
per-row scales (M, 1), the int8 nibble planes (Pa, M, Kp) that B1 takes,
zero beyond K, and for 5-8 bits the (M, K) codes: the eager path's ~18
launches a matmul (abs, max, divide, round, clamp, casts, digit
arithmetic, stack, pad), bit for bit. The JAX package has no kernel
here: XLA fuses the same step.

:func:`quant_grid` chooses the launch geometry from the observed shape: a
group of threads per row (a power of two, enough that each thread keeps
at most ``ITEMS`` vector loads of the row in registers), rows packed into
256-thread blocks, and fewer rows a block when M is too small to give
every SM a block. :func:`act_quant_cuda` takes rows whose columns are not
at unit stride by copying them first, and raises on anything else it does
not take (a CPU tensor, another dtype, bits outside 2 to 8): the caller
dispatches by device, and CUDA rows have no fallback.

``LAUNCHES`` counts successful launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime

LAUNCHES: Dict[str, int] = {"act_quant": 0}

ITEMS = 8        # vector loads a thread keeps in registers (csrc NV)
BLOCK = 256      # threads a block while a block holds several rows
MAX_GROUP = 512  # threads a row at most (csrc MAX_BLOCK); longer rows
                 # than MAX_GROUP * ITEMS * vec load their tail twice
SMS = 132        # an H100's SMs: fewer blocks than this, fewer rows each

# the row dtypes the kernel takes, and the C entry point's code for each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def quant_grid(m: int, k: int, vec: int) -> Tuple[int, int]:
    """``(group, rows)``: threads a row and rows a block for M rows of K
    elements loaded ``vec`` at a time. The group is the least power of two
    whose threads hold the row in ``ITEMS`` loads each (at most
    ``MAX_GROUP``); a block holds ``BLOCK`` threads' worth of rows (one
    row of a larger group), halved while that leaves fewer than ``SMS``
    blocks and a block stays a whole warp or more."""
    need = _cdiv(k, ITEMS * vec)
    group = 1
    while group < need and group < MAX_GROUP:
        group *= 2
    rows = max(1, BLOCK // group)
    while rows > 1 and _cdiv(m, rows) < SMS and group * rows > 32:
        rows //= 2
    return group, rows


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("act_quant")
    if lib.act_quant.argtypes is None:
        # x, ldx | planes, values, scale | m, k, kp, bits, bf16, vec, glog,
        # rows | stream
        lib.act_quant.argtypes = [_PTR, ctypes.c_longlong] + [_PTR] * 3 + \
            [_INT] * 8 + [_PTR]
        lib.act_quant.restype = _INT
    return lib


def _check_rows(x2: torch.Tensor, bits: int) -> None:
    if x2.device.type != "cuda" or x2.dtype not in _DTYPES or \
            x2.dim() != 2 or not 2 <= bits <= 8 or x2.shape[1] < 1 or \
            max(x2.shape) >= 2 ** 31:
        raise ValueError(
            "the CUDA kernel takes float32 or bfloat16 (M, K) rows on a "
            "CUDA device, K from 1 and sizes within int32, and 2 to 8 "
            f"bits, got {x2.dtype} {tuple(x2.shape)} on {x2.device}, bits "
            f"{bits}")


def act_quant_cuda(x2: torch.Tensor, bits: int, width: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Codes (M, K) int8, scales (M, 1) float32 and planes (Pa, M, width)
    int8 (``width`` default K; zero beyond K) of float32 or bfloat16 rows
    on the card, in one launch (none for M = 0). Up to 4 bits the codes
    are a view of the one plane. Raises ``ValueError`` on rows it does
    not take."""
    _check_rows(x2, bits)
    m, k = x2.shape
    kp = k if width is None else width
    if kp < k:
        raise ValueError(f"width {kp} is narrower than the rows' {k}")
    if (k > 1 and x2.stride(1) != 1) or (m > 1 and x2.stride(0) < k):
        x2 = x2.contiguous()
    dev = x2.device
    pa = 1 if bits <= 4 else 2
    planes = torch.empty((pa, m, kp), dtype=torch.int8, device=dev)
    codes = None if pa == 1 else \
        torch.empty((m, k), dtype=torch.int8, device=dev)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m:
        ldx = x2.stride(0) if m > 1 else k
        vec = 4 if k % 4 == 0 and kp % 4 == 0 and ldx % 4 == 0 and \
            x2.data_ptr() % (4 * x2.element_size()) == 0 else 1
        group, rows = quant_grid(m, k, vec)
        lib = _library()
        with torch.cuda.device(dev):
            rc = lib.act_quant(x2.data_ptr(), ldx, planes.data_ptr(),
                               None if codes is None else codes.data_ptr(),
                               scale.data_ptr(), m, k, kp, bits,
                               _DTYPES[x2.dtype], vec,
                               group.bit_length() - 1, rows,
                               runtime.stream_of(planes))
        runtime.check(lib, rc, "act_quant")
        LAUNCHES["act_quant"] += 1
    return planes[0, :, :k] if codes is None else codes, scale, planes
