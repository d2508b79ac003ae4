"""Launch wrappers for the hand-written Hopper PIM matmul kernel
(``repro_torch/csrc/pim_matmul.cu``).

Counterpart of ``repro/kernels/pim_matmul/pim_matmul.py``: one CUDA source,
templated on the plane counts, the bias, the row-sums and the epilogue,
replaces both Pallas kernels — ``pim_matmul_fused_pallas`` (dequant
epilogue) and ``pim_matmul_pallas`` (raw int32 accumulator). The kernel
masks ragged M, N and K itself, so these wrappers pad nothing: they check
device, dtype, shape and contiguity, allocate the outputs, launch on
PyTorch's current stream and raise on a launch error.

``LAUNCHES`` counts successful launches per kernel entry point, so a run
can show that its main path went through the kernels.

``kernel_tiles`` is the deterministic tile chooser of the JAX package,
kept unchanged: ``prepare_weights`` pads planes to it at programming time,
and plans keep the JAX layout.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime

DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = 512

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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("pim_matmul")
    if lib.pim_matmul_fused.argtypes is None:
        lib.pim_matmul_fused.argtypes = [_PTR] * 7 + [_INT] * 5 + [_PTR]
        lib.pim_matmul_fused.restype = _INT
        lib.pim_matmul_int.argtypes = [_PTR] * 3 + [_INT] * 5 + [_PTR]
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
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pim_matmul_fused(
            a_planes.data_ptr(), w_planes.data_ptr(), a_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if rowsum is None else rowsum.data_ptr(),
            pa, pw, m, k, n, runtime.stream_of(out))
    runtime.check(lib, rc, "pim_matmul_fused")
    LAUNCHES["pim_matmul_fused"] += 1
    return (out, rowsum) if want_rowsum else out


def pim_matmul_cuda(a_planes: torch.Tensor, w_planes: torch.Tensor
                    ) -> torch.Tensor:
    """The same accumulator without the epilogue: (M, N) int32."""
    pa, pw, m, k, n = _check_planes(a_planes, w_planes)
    out = torch.empty((m, n), dtype=torch.int32, device=a_planes.device)
    lib = _library()
    with torch.cuda.device(a_planes.device):
        rc = lib.pim_matmul_int(a_planes.data_ptr(), w_planes.data_ptr(),
                                out.data_ptr(), pa, pw, m, k, n,
                                runtime.stream_of(out))
    runtime.check(lib, rc, "pim_matmul_int")
    LAUNCHES["pim_matmul_int"] += 1
    return out
