"""Launch wrappers for the hand-written Hopper PIM matmul kernel
(``repro_torch/csrc/pim_matmul.cu``).

Counterpart of ``repro/kernels/pim_matmul/pim_matmul.py``: one CUDA source,
templated on the plane counts, replaces both Pallas kernels —
``pim_matmul_fused_pallas`` (dequant epilogue, optional bias and row-sums)
and ``pim_matmul_pallas`` (raw int32 accumulator). The source has two
routes of the same function, bit-identical to each other and to the plain
version in :mod:`.ref`:

- the **tiled** route (128 x 64 output tiles, K walked in each block) for
  M > ``SMALL_M_MAX``: CNN layers, LM prefill, ResNet18's fc at M = 128;
  bound by int8 tensor-core throughput or HBM bytes;
- the **small-M** route for 1 <= M <= ``SMALL_M_MAX`` (LM decode, M = the
  batch): strips of 32 or 64 output columns, split over K into a
  thread-block cluster whose ranks combine their uint32 partials through
  distributed shared memory, so each call stays one launch; bound by
  streaming the weight planes from HBM, and by launch latency for small
  planes.

:func:`small_m_grid` chooses the route, the strip and the K splits; its
integers go to the C entry points, so the choice is visible on the CPU.
The kernel masks ragged M, N and K itself, so these wrappers pad nothing:
they check device, dtype, shape and contiguity, allocate the outputs,
launch on PyTorch's current stream and raise on a launch error. The C
library also exports the tiled route under ``*_tiled`` names, as a
yardstick for the small-M route; these wrappers never call it.

``LAUNCHES`` counts successful launches per kernel entry point, so a run
can show that its main path went through the kernels.

``kernel_tiles`` is the deterministic tile chooser of the JAX package,
kept unchanged: ``prepare_weights`` pads planes to it at programming time,
and plans keep the JAX layout.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import runtime

DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = 512

# The small-M route (csrc/pim_matmul.cu SM_*), set by measurement on an
# H100 (PERF.md, PR 16): M up to SMALL_M_MAX tokens; strips of 64 columns
# where N leaves at least SMALL_M_WIDE_N / 64 of them, else 32; K split
# into a power of two of whole SMALL_M_BK-row ranges, as many as keep the
# launch within SMALL_M_MAX_BLOCKS blocks (three per SM of the 132).
# A strip's splits form one cluster: at most 16 blocks (the H100's
# non-portable cluster size), or the portable 8 above 32 tokens, where a
# block at w8a8 needs ~170 KB of shared memory and so an SM of its own.
SMALL_M_MAX = 64
SMALL_M_WIDE_N = 1024
SMALL_M_BK = 128
SMALL_M_MAX_SPLITS = 16
SMALL_M_WIDE_SPLITS = 8
SMALL_M_MAX_BLOCKS = 3 * 132

LAUNCHES: Dict[str, int] = {"pim_matmul_fused": 0, "pim_matmul_int": 0}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def kernel_tiles(m: int, k: int, n: int, bm: int = DEFAULT_BM,
                 bn: int = DEFAULT_BN, bk: int = DEFAULT_BK
                 ) -> Tuple[int, int, int]:
    """Deterministic (bm, bn, bk) tile selection for problem (M, K, N).

    Shared with ``prepare_weights`` so that planes padded once at
    programming time keep the reference's layout: for any K' that is a
    multiple of ``ceil(k/bk)*bk`` the recomputed tile divides it exactly.
    """
    return min(bm, m), min(bn, n), min(bk, k)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def small_m_grid(m: int, k: int, n: int) -> Tuple[str, int, int]:
    """``(route, strip, splits)`` for an (M, K) x (K, N) call: ``("tiled",
    0, 0)`` above ``SMALL_M_MAX`` tokens (or for an empty M), else
    ``("small_m", strip, splits)`` with ``splits`` K ranges per strip,
    each a whole number of stages (:func:`split_ranges`)."""
    if m < 1 or m > SMALL_M_MAX:
        return "tiled", 0, 0
    strip = 64 if n >= SMALL_M_WIDE_N else 32
    strips = max(1, _cdiv(n, strip))
    cap = min(SMALL_M_MAX_SPLITS if m <= 32 else SMALL_M_WIDE_SPLITS,
              max(1, _cdiv(k, SMALL_M_BK)))
    want = 1
    while want * 2 <= cap and strips * want * 2 <= SMALL_M_MAX_BLOCKS:
        want *= 2
    per = _cdiv(_cdiv(k, want), SMALL_M_BK) * SMALL_M_BK
    return "small_m", strip, max(1, _cdiv(k, per)) if k else 1


def split_ranges(k: int, splits: int) -> List[Tuple[int, int]]:
    """The K range ``[lo, hi)`` of each cluster rank, as the kernel
    computes it from ``splits``: whole stages of ``SMALL_M_BK`` rows, the
    last one cut at K."""
    per = _cdiv(_cdiv(k, splits), SMALL_M_BK) * SMALL_M_BK
    return [(min(k, r * per), min(k, r * per + per)) for r in range(splits)]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("pim_matmul")
    if lib.pim_matmul_fused.argtypes is None:
        lib.pim_matmul_fused.argtypes = [_PTR] * 7 + [_INT] * 7 + [_PTR]
        lib.pim_matmul_fused.restype = _INT
        lib.pim_matmul_int.argtypes = [_PTR] * 3 + [_INT] * 7 + [_PTR]
        lib.pim_matmul_int.restype = _INT
    return lib


def _check_planes(a_planes: torch.Tensor, w_planes: torch.Tensor
                  ) -> Tuple[int, int, int, int, int]:
    if a_planes.device.type != "cuda" or w_planes.device != a_planes.device:
        raise ValueError("the CUDA kernel takes planes on one CUDA device, "
                         f"got {a_planes.device} and {w_planes.device}")
    for name, t in (("a_planes", a_planes), ("w_planes", w_planes)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D int8 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    pa, m, k = a_planes.shape
    pw, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if pa not in (1, 2) or pw not in (1, 2):
        raise ValueError(f"plane counts must be 1 or 2, got {pa}, {pw}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"dimensions must fit in int32, got {m, k, n}")
    return pa, pw, m, k, n


def _check_vector(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def pim_matmul_fused_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor,
                          a_scale: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          want_rowsum: bool = False):
    """Bit-sliced integer matmul with the fused dequant epilogue, on the
    card. a_planes (Pa, M, K) int8, w_planes (Pw, K, N) int8, a_scale
    (M, 1) f32, w_scale (1, N) f32, bias (1, N) f32 or None -> (M, N) f32,
    or ``(out, rowsum)`` with the (M,) int32 row-sums."""
    pa, pw, m, k, n = _check_planes(a_planes, w_planes)
    dev = a_planes.device
    _check_vector("a_scale", a_scale, (m, 1), dev)
    _check_vector("w_scale", w_scale, (1, n), dev)
    if bias is not None:
        _check_vector("bias", bias, (1, n), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rowsum = torch.zeros((m,), dtype=torch.int32, device=dev) \
        if want_rowsum else None
    _, strip, splits = small_m_grid(m, k, n)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pim_matmul_fused(
            a_planes.data_ptr(), w_planes.data_ptr(), a_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if rowsum is None else rowsum.data_ptr(),
            pa, pw, m, k, n, strip, splits, runtime.stream_of(out))
    runtime.check(lib, rc, "pim_matmul_fused")
    LAUNCHES["pim_matmul_fused"] += 1
    return (out, rowsum) if want_rowsum else out


def pim_matmul_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor
                    ) -> torch.Tensor:
    """The same accumulator without the epilogue: (M, N) int32."""
    pa, pw, m, k, n = _check_planes(a_planes, w_planes)
    out = torch.empty((m, n), dtype=torch.int32, device=a_planes.device)
    _, strip, splits = small_m_grid(m, k, n)
    lib = _library()
    with torch.cuda.device(a_planes.device):
        rc = lib.pim_matmul_int(a_planes.data_ptr(), w_planes.data_ptr(),
                                out.data_ptr(), pa, pw, m, k, n, strip,
                                splits, runtime.stream_of(out))
    runtime.check(lib, rc, "pim_matmul_int")
    LAUNCHES["pim_matmul_int"] += 1
    return out
