"""Launch wrappers for the hand-written Hopper flash-attention kernels
(``repro_torch/csrc/flash_attention.cu``), forward and backward.

Counterpart of ``repro/kernels/flash_attention/flash_attention.py``: the
forward replaces ``flash_attention_pallas``; the backward is its
gradient, which training needs because the forward sits inside the
training step. :class:`FlashAttention` ties them together for autograd:
its forward launches the forward kernel and saves the per-row
log-sum-exp, its backward launches the backward kernels: a dQ pass that
also forms rowsum(dO * O), a dK/dV pass per query head and, with GQA, the
sum of each kv head's query heads.

Each kernel has its own wrapper, which checks device, dtype, shape and
contiguity, allocates the outputs, launches on PyTorch's current stream,
raises on a launch error and adds one to its entry of ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0,
                            "flash_attention_bwd_sum": 0}
MAX_D = 256   # the kernels' columns per lane are compiled for D <= 256

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = runtime.load_library("flash_attention")
    if lib.flash_fwd.argtypes is None:
        # q, k, v, o, lse | bf16, b, s, h, kv, d, causal, window, prefix |
        # stream
        lib.flash_fwd.argtypes = [_PTR] * 5 + [_INT] * 9 + [_PTR]
        lib.flash_fwd.restype = _INT
        # q, k, v, o, dout, lse, dq, delta | b, s, h, kv, d, causal,
        # window, prefix | stream
        lib.flash_bwd_dq.argtypes = [_PTR] * 8 + [_INT] * 8 + [_PTR]
        lib.flash_bwd_dq.restype = _INT
        # q, k, v, dout, lse, delta, dk, dv | b, s, h, kv, d, causal,
        # window, prefix | stream
        lib.flash_bwd_dkv.argtypes = [_PTR] * 8 + [_INT] * 8 + [_PTR]
        lib.flash_bwd_dkv.restype = _INT
        # dk_part, dv_part, dk, dv | b, s, h, kv, d | stream
        lib.flash_bwd_sum.argtypes = [_PTR] * 4 + [_INT] * 5 + [_PTR]
        lib.flash_bwd_sum.restype = _INT
        lib.flash_smem_bytes.argtypes = [_INT, _INT]
        lib.flash_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dtypes: Tuple[torch.dtype, ...], window: int,
                  prefix_len: int) -> Tuple[int, int, int, int, int]:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (b, s, h, d) and k, v (b, s, kv, d), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if q.dtype not in dtypes:
        raise ValueError(f"q must be one of {dtypes}, got {q.dtype}")
    for name, t, shape in (("q", q, (b, s, h, d)), ("k", k, (b, s, kv, d)),
                           ("v", v, (b, s, kv, d))):
        if t.device != dev or t.dtype != q.dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if min(b, s, h, kv, d) < 1 or h % kv or d > MAX_D:
        raise ValueError(f"need non-empty dims, h % kv == 0 and d <= "
                         f"{MAX_D}, got (b, s, h, kv, d)={b, s, h, kv, d}")
    if window < 0 or prefix_len < 0:
        raise ValueError(f"window and prefix_len must be >= 0, got "
                         f"{window}, {prefix_len}")
    return b, s, h, kv, d


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window: int = 0, prefix_len: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (b, s, h, d), k and v (b, s, kv, d), contiguous float32 or
    bfloat16 on one CUDA device, d <= 256. Returns the output (b, s, h, d)
    in q's dtype and the per-row log-sum-exp (b, h, s) in float32.

    One kernel for both dtypes, on the tensor cores: float32 products as
    3xTF32 (float32 accuracy); bfloat16 inputs are exact in TF32, so the
    kernel skips their zero lo parts (one product for the logits, two for
    P V). The CUDA-core kernel it replaced stays in the library as
    ``flash_fwd_simt``, a yardstick that no wrapper calls."""
    b, s, h, kv, d = _check_inputs(q, k, v, (torch.float32, torch.bfloat16),
                                   window, prefix_len)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(),
                           int(q.dtype == torch.bfloat16), b, s, h, kv, d,
                           int(causal), window, prefix_len,
                           runtime.stream_of(q))
    if rc != 0:
        smem = lib.flash_smem_bytes(5 if q.dtype == torch.bfloat16 else 0, d)
        runtime.check(lib, rc, f"flash_fwd (d={d}: {smem} bytes of shared "
                               "memory per block)")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _check_f32(device, named_shapes) -> None:
    for name, t, shape in named_shapes:
        if t.device != device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, dout: torch.Tensor,
                                causal: bool = True, window: int = 0,
                                prefix_len: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward, first kernel: dq (b, s, h, d) and delta = rowsum(dout *
    o) (b, h, s) from the forward's inputs, output ``o`` and log-sum-exp
    ``lse``; all float32 and contiguous."""
    b, s, h, kv, d = _check_inputs(q, k, v, (torch.float32,), window,
                                   prefix_len)
    _check_f32(q.device, (("o", o, (b, s, h, d)), ("dout", dout,
                                                   (b, s, h, d)),
                          ("lse", lse, (b, h, s))))
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                              dq.data_ptr(), delta.data_ptr(), b, s, h, kv,
                              d, int(causal), window, prefix_len,
                              runtime.stream_of(q))
    if rc != 0:
        runtime.check(lib, rc, f"flash_bwd_dq (d={d}: "
                               f"{lib.flash_smem_bytes(1, d)} bytes of "
                               "shared memory per block)")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq, delta


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lse: torch.Tensor,
                                 delta: torch.Tensor, dout: torch.Tensor,
                                 causal: bool = True, window: int = 0,
                                 prefix_len: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward, second kernel: dk and dv of every query head, (b, s, h,
    d) each (with h == kv, the gradients), from the forward's inputs and
    log-sum-exp and the first kernel's ``delta``; float32, contiguous."""
    b, s, h, kv, d = _check_inputs(q, k, v, (torch.float32,), window,
                                   prefix_len)
    _check_f32(q.device, (("dout", dout, (b, s, h, d)),
                          ("lse", lse, (b, h, s)),
                          ("delta", delta, (b, h, s))))
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), b, s, h, kv, d, int(causal),
                               window, prefix_len, runtime.stream_of(q))
    if rc != 0:
        runtime.check(lib, rc, f"flash_bwd_dkv (d={d}: "
                               f"{lib.flash_smem_bytes(2, d)} bytes of "
                               "shared memory per block)")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_sum_cuda(dk_part: torch.Tensor,
                                 dv_part: torch.Tensor, kv: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward, third kernel (GQA): dk and dv (b, s, kv, d), each kv
    head the sum of its h / kv query heads' partials (b, s, h, d) in head
    order; float32, contiguous."""
    if dk_part.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{dk_part.device}")
    if dk_part.dim() != 4:
        raise ValueError(f"dk_part must be (b, s, h, d), got "
                         f"{tuple(dk_part.shape)}")
    b, s, h, d = dk_part.shape
    if min(b, s, h, d, kv) < 1 or h % kv:
        raise ValueError(f"need non-empty dims and h % kv == 0, got "
                         f"(b, s, h, kv, d)={b, s, h, kv, d}")
    _check_f32(dk_part.device, (("dk_part", dk_part, (b, s, h, d)),
                                ("dv_part", dv_part, (b, s, h, d))))
    dk = dk_part.new_empty((b, s, kv, d))
    dv = dk_part.new_empty((b, s, kv, d))
    lib = _library()
    with torch.cuda.device(dk_part.device):
        rc = lib.flash_bwd_sum(dk_part.data_ptr(), dv_part.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), b, s, h, kv, d,
                               runtime.stream_of(dk_part))
    if rc != 0:
        runtime.check(lib, rc, "flash_bwd_sum")
    LAUNCHES["flash_attention_bwd_sum"] += 1
    return dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             prefix_len: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients (dq, dk, dv) of the forward's output against ``dout``,
    from the forward's inputs, output ``o`` and log-sum-exp ``lse``; all
    float32 and contiguous. dk and dv are summed over the query heads of
    each kv head. Two kernel launches, three with GQA."""
    mask = (causal, window, prefix_len)
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, o, lse, dout, *mask)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout, *mask)
    if q.shape[2] > k.shape[2]:
        dk, dv = flash_attention_bwd_sum_cuda(dk, dv, k.shape[2])
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention whose forward and backward are the CUDA kernels.
    The backward takes float32 only (training runs in float32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix_len: int):
        o, lse = flash_attention_fwd_cuda(q, k, v, causal, window,
                                          prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, prefix_len)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse,
                                              dout.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         prefix_len: int = 0) -> torch.Tensor:
    """The forward kernel, differentiable through the backward kernel."""
    return FlashAttention.apply(q, k, v, causal, window, prefix_len)
