"""Launch wrapper for the hand-written Hopper SSD scan kernel
(``repro_torch/csrc/ssd_scan.cu``).

Counterpart of ``repro/kernels/ssd_scan/ssd_scan.py``: one block per
(batch*head) row walks its chunks in order with the (N, P) state kept in
shared memory, replacing ``ssd_scan_pallas``. The kernel masks a ragged
tail itself (``L % chunk != 0``), so the wrapper pads nothing: it checks
device, dtype, shape and contiguity, allocates the outputs, launches on
PyTorch's current stream and raises on a launch error (including a
block that would need more shared memory than the card has).

``LAUNCHES`` counts successful launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime

LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
MAX_P = 128   # the kernel's columns per lane are compiled for P <= 128

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        # x, a, b, c, y, sfin | bh, l, p, n, chunk | stream
        lib.ssd_scan.argtypes = [_PTR] * 6 + [_INT] * 5 + [_PTR]
        lib.ssd_scan.restype = _INT
        lib.ssd_scan_smem_bytes.argtypes = [_INT] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH, L, P), a (BH, L), b and c (BH, L, N), contiguous float32 on
    one CUDA device; ``chunk`` in [1, L]; P at most 128. Returns y (BH, L, P) and the
    final state (BH, N, P)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if x.dim() != 3:
        raise ValueError(f"x must be (BH, L, P), got {tuple(x.shape)}")
    bh, l, p = x.shape
    n = b.shape[-1]
    for name, t, shape in (("x", x, (bh, l, p)), ("a", a, (bh, l)),
                           ("b", b, (bh, l, n)), ("c", c, (bh, l, n))):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= chunk <= l or min(bh, p, n) < 1 or p > MAX_P:
        raise ValueError(f"need 1 <= chunk <= L, P <= {MAX_P} and non-empty "
                         f"dims, got chunk={chunk}, (BH, L, P, N)="
                         f"{bh, l, p, n}")
    if max(bh * l * max(p, n), bh * n * p) >= 2 ** 31:
        raise ValueError("the kernel indexes with int32 per-row offsets; "
                         f"(BH, L, P, N)={bh, l, p, n} is too large")
    y = torch.empty((bh, l, p), dtype=torch.float32, device=dev)
    s_fin = torch.empty((bh, n, p), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.ssd_scan(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                          c.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
                          bh, l, p, n, chunk, runtime.stream_of(y))
    if rc != 0:
        smem = lib.ssd_scan_smem_bytes(p, n, chunk)
        runtime.check(lib, rc, f"ssd_scan (P={p}, N={n}, chunk={chunk}: "
                               f"{smem} bytes of shared memory per block)")
    LAUNCHES["ssd_scan"] += 1
    return y, s_fin
