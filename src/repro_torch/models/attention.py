"""Attention: GQA/MQA, qk-norm, QKV bias, sliding windows, RoPE; full and
blockwise prefill, the KV-cache decode path and the encoder-decoder
cross-attention (counterpart of ``repro/models/attention.py``).

All q/k/v/o projections go through :func:`repro_torch.models.layers.proj`,
so projections programmed into PIM plans run on the plan's substrate.

Windows are Python ints here (``0`` = global attention): the port loops
over layers in Python, where the JAX package threads a traced per-layer
window array through ``lax.scan``. ``_mask`` computes the same thing for
both.

``attention_block`` takes the JAX package's attention backends:
``"jnp"`` (plain tensor ops, the config default) and ``"cuda"``, the
hand-written flash-attention kernel (``kernels/flash_attention``,
forward and backward), with the JAX names ``"pallas"`` and
``"pallas_interp"`` as aliases. The kernel route takes every length
(the kernel masks a ragged last tile), so it runs whenever the backend
asks for it; on CPU tensors it is the kernel's plain version. JAX's route
also needs ``s % block == 0`` and integer windows, which its scanned
(traced) window never is, so JAX's ``lm.forward`` never reaches its
kernel where the port's does.

Sharded training (a training ``ShardingContext``): when whole query heads
of ``wq_dh``'s column split fall on each rank, each rank projects and
attends its own block of query heads; K and V come split along the same
head boundaries when the KV heads divide, else whole (gathered, e.g.
gemma3-1b's one KV head split along head_dim) and cut to the KV heads the
rank's query block reads. qk-norm's weight enters a rank's heads with its
gradient summed over the axis. A split that falls mid-head gathers q and
attends every head on every rank. ``wo_hd``'s row split takes either.
GQA grouping is contiguous: query head h reads KV head h // (H / KV).
Cross-attention splits the same way, its K and V projected from the
encoder's output (whole on every rank, its gradient summed over the
axis by the column split's input crossing).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.analysis import trace
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import (Params, apply_rope, dense_init, proj,
                                       rms_norm, shared, split_of,
                                       split_ranks, whole)

NEG_INF = -1e30
ATTN_BACKENDS = flash_ops.BACKENDS + tuple(flash_ops.BACKEND_ALIASES)


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qk_norm: bool = False,
                   qkv_bias: bool = False, device=None,
                   dtype=torch.float32) -> Params:
    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, device=device, dtype=dtype)

    p = {"wq_dh": dense(d_model, num_heads * head_dim),
         "wk_dh": dense(d_model, num_kv_heads * head_dim),
         "wv_dh": dense(d_model, num_kv_heads * head_dim),
         "wo_hd": dense(num_heads * head_dim, d_model)}
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    if qkv_bias:
        p["bq_bh"] = zeros(num_heads * head_dim)
        p["bk_bh"] = zeros(num_kv_heads * head_dim)
        p["bv_bh"] = zeros(num_kv_heads * head_dim)
    if qk_norm:
        p["qnorm_d"] = zeros(head_dim)
        p["knorm_d"] = zeros(head_dim)
    return p


def _project_qkv(p: Params, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                 rope_theta: float, norm_eps: float = 1e-6,
                 use_rope: bool = True):
    b, s, _ = x.shape
    q = proj(x, p["wq_dh"])
    k = proj(x, p["wk_dh"])
    v = proj(x, p["wv_dh"])
    if "bq_bh" in p:
        q, k, v = q + p["bq_bh"], k + p["bk_bh"], v + p["bv_bh"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if "qnorm_d" in p:
        q = rms_norm(q, p["qnorm_d"], norm_eps)
        k = rms_norm(k, p["knorm_d"], norm_eps)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _query_block(p: Params, num_heads: int) -> Optional[Tuple[int, int]]:
    """This rank's query heads ``[lo, hi)`` when ``wq_dh`` is stored split
    into whole heads, else None."""
    tp, r = split_ranks(p["wq_dh"], "wq_dh")
    if tp == 1 or num_heads % tp:
        return None
    per = num_heads // tp
    return r * per, (r + 1) * per


def _kv_for_block(t: torch.Tensor, lo: int, hi: int, num_heads: int
                  ) -> torch.Tensor:
    """The KV heads of whole ``t`` (b, s, KV, d) that query heads
    ``[lo, hi)`` read, laid out so that the block's contiguous grouping
    holds: the block's KV range where it covers whole groups or sits in
    one, else one KV head per query head."""
    rep = num_heads // t.shape[2]
    first, last = lo // rep, (hi - 1) // rep + 1
    n = last - first
    if (hi - lo) % n == 0 and all(
            (lo + i) // rep == first + i // ((hi - lo) // n)
            for i in range(hi - lo)):
        return t[:, :, first:last]
    heads = torch.arange(lo, hi, device=t.device) // rep
    return t.index_select(2, heads)


def _project_qkv_split(p: Params, x: torch.Tensor, num_heads: int,
                       num_kv_heads: int, head_dim: int,
                       positions: Optional[torch.Tensor], rope_theta: float,
                       norm_eps: float, block: Optional[Tuple[int, int]],
                       kv_x: Optional[torch.Tensor] = None):
    """:func:`_project_qkv` under sharded training. With a query ``block``
    q holds this rank's heads and k/v the KV heads they read; without one
    q, k and v are whole on every rank. ``kv_x`` is the keys' and values'
    source when it is not ``x`` (cross-attention's encoder output);
    ``positions`` None applies no RoPE."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    t = kv_x.shape[1]
    local = block is not None
    kv_local = local and num_kv_heads % (
        num_heads // (block[1] - block[0])) == 0
    q = proj(x, p["wq_dh"], "wq_dh", local=local)
    k = proj(kv_x, p["wk_dh"], "wk_dh", local=kv_local)
    v = proj(kv_x, p["wv_dh"], "wv_dh", local=kv_local)
    if "bq_bh" in p:
        q = q + (p["bq_bh"] if local else whole(p["bq_bh"], "bq_bh"))
        k = k + (p["bk_bh"] if kv_local else whole(p["bk_bh"], "bk_bh"))
        v = v + (p["bv_bh"] if kv_local else whole(p["bv_bh"], "bv_bh"))
    q = q.reshape(b, s, -1, head_dim)
    k = k.reshape(b, t, -1, head_dim)
    v = v.reshape(b, t, -1, head_dim)
    if "qnorm_d" in p:
        q = rms_norm(q, shared(p["qnorm_d"], p["wq_dh"], "wq_dh")
                     if local else p["qnorm_d"], norm_eps)
        k = rms_norm(k, shared(p["knorm_d"], p["wk_dh"], "wk_dh")
                     if kv_local else p["knorm_d"], norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if local and not kv_local:      # whole K/V into this rank's heads
        mesh, axis, _ = split_of(p["wq_dh"], "wq_dh")
        k = _kv_for_block(coll.copy_to(k, mesh, axis), *block, num_heads)
        v = _kv_for_block(coll.copy_to(v, mesh, axis), *block, num_heads)
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
          causal: bool, prefix_len: int = 0) -> torch.Tensor:
    """(..., q, k) boolean validity mask; ``window`` 0 = unbounded;
    ``prefix_len`` > 0 gives a prefix-LM mask (full attention within the
    first ``prefix_len`` positions)."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = (diff >= 0) if causal else torch.ones_like(diff, dtype=torch.bool)
    in_prefix = k_pos[..., None, :] < prefix_len
    ok = ok | in_prefix
    if window > 0:
        ok = ok & ((diff < window) | in_prefix)
    return ok


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (b,s,h,d), k/v: (b,t,kv,d), mask: (b,s,t) or (s,t). Logits in
    float32 (a bf16 cache promotes to q's f32, as in JAX); the
    probabilities take v's dtype, and so does the output."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, s, kv, rep, d).to(dt)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k.to(dt)).to(
        torch.float32)
    logits = logits / math.sqrt(d)
    m = mask if mask.dim() == 3 else mask[None]
    # a Python scalar, not a tensor made from one: no host->device copy
    logits = torch.where(m[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return out.reshape(b, s, h, d)


def full_attention(q, k, v, positions, window: int = 0, causal=True,
                   prefix_len: int = 0) -> torch.Tensor:
    mask = _mask(positions, positions, window, causal, prefix_len)
    return _sdpa(q, k, v, mask)


def blockwise_attention(q, k, v, positions, window: int = 0, causal=True,
                        block: int = 512, prefix_len: int = 0
                        ) -> torch.Tensor:
    """Online softmax over KV blocks; O(S·block) memory."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    if s % block != 0:
        return full_attention(q, k, v, positions, window, causal, prefix_len)
    qg = (q.reshape(b, s, kvh, rep, d) / math.sqrt(d)).to(q.dtype)
    acc = torch.zeros((b, kvh, rep, s, d), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((b, kvh, rep, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, kvh, rep, s), dtype=torch.float32,
                        device=q.device)
    for start in range(0, s, block):
        kc = k[:, start:start + block]
        vc = v[:, start:start + block]
        pc = positions[:, start:start + block]
        logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                              kc.to(torch.float32))
        mask = _mask(positions, pc, window, causal, prefix_len)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        scale = torch.exp(m_run - m_new)
        p = torch.exp(logits - m_new[..., None])
        acc = acc * scale[..., None] + torch.einsum(
            "bkrst,btkd->bkrsd", p.to(vc.dtype).to(torch.float32),
            vc.to(torch.float32))
        l_run = l_run * scale + p.sum(dim=-1)
        m_run = m_new
    out = acc / torch.clamp_min(l_run[..., None], 1e-37)
    out = out.reshape(b, kvh * rep, s, d).transpose(1, 2)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  layers: Optional[int] = None, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Zero KV cache: k/v of shape (B, S, kv, hd), or (L, B, S, kv, hd)
    with ``layers`` set (the stacked-layer layout)."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    if layers is not None:
        shape = (layers,) + shape
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     index: Union[int, torch.Tensor], num_heads: int,
                     num_kv_heads: int, head_dim: int, rope_theta: float,
                     window: int = 0, norm_eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-block decode. x: (b, c, d); cache k/v: (b, S, kv, hd); index:
    the position of the block's first token, a Python int (or 0-d tensor)
    shared by the batch or a per-row (b,) tensor. The c new K/V rows land
    at positions index + [0, c), written into the cache tensors in place
    (the JAX package returns updated copies; the port saves the copy).
    Queries attend causally within the block. Returns (out, cache)."""
    b, c = x.shape[0], x.shape[1]
    dev = x.device
    offs = torch.arange(c, dtype=torch.int64, device=dev)
    per_slot = torch.is_tensor(index) and index.dim() == 1
    if per_slot:
        start = index.to(device=dev, dtype=torch.int64)
    else:
        start = torch.full((b,), int(index), dtype=torch.int64, device=dev)
    positions = start[:, None] + offs[None]                       # (b, c)
    q, k_new, v_new = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                                   positions, rope_theta, norm_eps)
    k, v = cache["k"], cache["v"]
    if per_slot:
        rows = torch.arange(b, device=dev)[:, None]
        k[rows, positions] = k_new.to(k.dtype)
        v[rows, positions] = v_new.to(v.dtype)
    else:
        i = int(index)
        k[:, i:i + c] = k_new.to(k.dtype)
        v[:, i:i + c] = v_new.to(v.dtype)
    k_pos = torch.arange(k.shape[1], dtype=torch.int64,
                         device=dev)[None, None, :]              # (1,1,S)
    pos3 = positions[:, :, None]                                  # (b,c,1)
    valid = k_pos <= pos3
    if window > 0:
        valid = valid & (pos3 - k_pos < window)
    out = _sdpa(q, k, v, valid)
    out = out.reshape(b, c, num_heads * head_dim)
    return proj(out, p["wo_hd"]), {"k": k, "v": v}


def attention_block(p: Params, x: torch.Tensor, positions: torch.Tensor,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    rope_theta: float, window: int = 0, causal: bool = True,
                    norm_eps: float = 1e-6, block: int = 512,
                    blockwise_threshold: int = 2048, prefix_len: int = 0,
                    return_kv: bool = False, backend: str = "jnp"):
    """Training/prefill attention: the flash kernel route where the backend
    asks for it, else blockwise above the threshold, else full attention."""
    flash = flash_ops.resolve_backend(backend) == "cuda"
    if split_of(p["wq_dh"], "wq_dh") is None:
        q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                               positions, rope_theta, norm_eps)
    else:
        q, k, v = _project_qkv_split(p, x, num_heads, num_kv_heads,
                                     head_dim, positions, rope_theta,
                                     norm_eps, _query_block(p, num_heads))
    s = x.shape[1]
    route = "flash" if flash else (
        "blockwise" if s > blockwise_threshold else "full")
    with trace.fine("attn.prompt", route):
        if flash:
            out = flash_ops.flash_attention(q, k, v, causal, window,
                                            prefix_len)
        elif s > blockwise_threshold:
            out = blockwise_attention(q, k, v, positions, window, causal,
                                      block, prefix_len)
        else:
            out = full_attention(q, k, v, positions, window, causal,
                                 prefix_len)
    out = proj(out.reshape(x.shape[0], s, -1), p["wo_hd"], "wo_hd")
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# encoder-decoder cross-attention (whisper)
# ---------------------------------------------------------------------------
def cross_attention_block(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                          num_heads: int, num_kv_heads: int, head_dim: int,
                          return_kv: bool = False):
    """Decoder queries over the encoder's output: no RoPE, no mask. K and
    V are projected from ``enc_out`` here (float32 in prefill; the caller
    stores them in the cache's dtype). Plain tensor ops around ``proj``,
    as the JAX package computes it (its query and key lengths differ, and
    it reaches no Pallas kernel). The projections are
    :func:`_project_qkv_split`'s with the encoder's output as the K/V
    source: on a whole leaf or a plan exactly ``proj``; under sharded
    training q, k and v split by heads as the self-attention's (the rank
    attends its heads) and ``wo_hd`` is a row split."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    q, k, v = _project_qkv_split(
        p, x, num_heads, num_kv_heads, head_dim, positions=None,
        rope_theta=0.0, norm_eps=1e-6, block=_query_block(p, num_heads),
        kv_x=enc_out)
    mask = torch.ones((b, s, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask).reshape(b, s, -1)
    out = proj(out, p["wo_hd"], "wo_hd")
    if return_kv:
        return out, (k, v)
    return out


def cross_attention_decode(p: Params, x: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, num_heads: int,
                           num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """Decode-time cross-attention against the encoder K/V that prefill
    stored in the cache (in the cache's dtype, read as stored: a bf16
    cache gives bf16 probabilities and output, as in JAX)."""
    b, s, _ = x.shape
    t = xk.shape[1]
    q = proj(x, p["wq_dh"], "wq_dh").reshape(b, s, num_heads, head_dim)
    mask = torch.ones((b, s, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, xk, xv, mask).reshape(b, s, num_heads * head_dim)
    return proj(out, p["wo_hd"], "wo_hd")
