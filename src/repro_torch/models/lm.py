"""The LM stack for every assigned architecture (counterpart of
``repro/models/lm.py``).

One parameterized decoder (and an optional encoder) covering dense
GQA/MQA attention (qk-norm, QKV bias, sliding windows, RoPE), gated MLPs
or MoE FFNs (top-k routed experts, optional shared experts:
:mod:`repro_torch.models.moe`), Mamba2 SSD layers, hymba-style parallel
attention + SSM blocks, the whisper-style encoder-decoder with
cross-attention and the paligemma-style VLM prefix (stub patch
embeddings through the ``vproj_dh`` projector). Layer parameters are
stacked along a leading layer axis, as in the JAX package, and the layers
run as a Python loop over it (:func:`layer_trees` splits every stacked
leaf once per call with ``torch.unbind``; a leaf that is a list, such as
the per-layer plans of ``plan_params_for_pim``, gives its entries).
Per-layer sliding windows are Python ints, so ``forward`` with
``attn_backend="cuda"`` reaches the flash-attention kernel (forward and
backward), which JAX's scan over a traced window array never does.
``prefill`` passes no backend to the decoder's attention, as in the JAX
package. ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``), the counterpart of ``jax.checkpoint``.

The two input families thread through every layer as JAX threads them:
- ``prefix_len``: :func:`_embed_inputs` puts ``patches @ vproj_dh`` before
  the token embeddings and returns the patch count, and each decoder
  layer's self-attention takes it as a prefix-LM mask (the prefix's
  positions attend to each other in both directions). The logits cover the
  prefix positions too; the loss drops them
  (``launch.train.lm_loss``), and a cache's positions count them.
- ``enc_out``: :func:`encode` runs the encoder stack on ``frames``
  (non-causal, window 0 on every layer, ``cfg.attn_backend`` passed on)
  and each decoder layer cross-attends to its output after the mixer
  (``lnx_d``, ``xattn``). ``prefill`` stores the cross-attention's K/V in
  the cache (``xk``/``xv``, in ``cache_dtype``); ``decode_step`` reads
  them there.
``prefill_chunk`` refuses both families, as in the JAX package.

Under a training ``ShardingContext`` (``launch.train.make_train_step(...,
mesh=)``) ``forward`` runs this rank's part of a tensor-parallel step:
the layers' call sites name their leaves, the embedding is vocab-parallel
and the logits it returns are this rank's block of the vocab, masked at
the block's offset (``launch.train.cross_entropy`` reduces them). The
encoder stack runs split like the decoder's (its row splits end in a
sum, so ``enc_out`` is whole on every rank), cross-attention splits by
heads (``attention.cross_attention_block``) and the patch projector
``vproj_dh`` is a named column split, gathered before the prefix joins
the token embeddings.

API:
  init_lm(cfg, gen, device[, layer_fn])       -> params
  forward(params, cfg, batch)                 -> logits, aux
  encode(params, cfg, frames)                 -> encoder output
  prefill(params, cfg, batch, max_len)        -> logits, cache
  prefill_chunk(params, cfg, cache, tok, at)  -> logits, cache
  decode_step(params, cfg, cache, token, idx) -> logits, cache
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pim import Plan
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.layers import (Params, dense_init, embed,
                                       embedding_init, mlp_apply,
                                       mlp_init, proj, rms_norm,
                                       unembed, vocab_shard)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block type the LM stack does not know."""
    if cfg.block_type not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown block_type {cfg.block_type!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, gen: torch.Generator, device,
                cross_attention: bool = False) -> Params:
    p: Params = {"ln1_d": torch.zeros((cfg.d_model,), device=device)}
    if cfg.block_type in ("attn", "hybrid") or cross_attention:
        p["attn"] = attn.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias, device=device)
    if cfg.block_type in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.ssm_init(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
            cfg.ssm_head_dim, cfg.ssm_groups, device=device)
    if cross_attention:
        p["lnx_d"] = torch.zeros((cfg.d_model,), device=device)
        p["xattn"] = attn.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            device=device)
    if cfg.d_ff > 0 or cfg.is_moe:
        p["ln2_d"] = torch.zeros((cfg.d_model,), device=device)
        if cfg.is_moe:
            p["moe"] = moe_init(gen, cfg.d_model, cfg.num_experts,
                                cfg.moe_d_ff,
                                shared_experts=cfg.shared_experts,
                                shared_d_ff=cfg.moe_d_ff, device=device)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff,
                                gated=cfg.gated_mlp, device=device)
    return p


def stack_layers(trees: List[Any]) -> Any:
    """Per-layer trees -> one tree: tensors stacked along a new leading
    layer axis, plans gathered into a per-layer list (the form
    ``launch.serve.plan_params_for_pim`` gives)."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], Plan):
        return list(trees)
    return torch.stack(trees)


def init_lm(cfg: ModelConfig, gen: Union[int, torch.Generator],
            device=None, layer_fn=None) -> Params:
    """Random parameters from ``gen`` (a ``torch.Generator`` on
    ``device``, or an int seed for one), layers stacked along a leading
    axis. ``device=None`` means CUDA. The numbers are drawn in a fixed
    order, that of the JAX package's key split: the embedding, the
    decoder layers in order (with cross-attention when the config has an
    encoder), the unembedding, the encoder layers in order, the patch
    projector ``vproj_dh``.

    ``layer_fn``, if given, maps each layer's tree as soon as it is drawn,
    called as ``layer_fn(tree, stack)`` with ``stack`` the stack's key
    (``"layers"`` or ``"enc_layers"``; serving programs the layer into
    plans there), so only one layer's float weights exist at a time; the
    result equals mapping every layer of the stacked trees afterwards,
    bit for bit."""
    check_supported(cfg)
    device = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))

    def stack(key, n, cross_attention=False):
        layers = []
        for _ in range(n):
            layer = _init_layer(cfg, gen, device, cross_attention)
            layers.append(layer if layer_fn is None else layer_fn(layer, key))
        return stack_layers(layers)

    params: Params = {
        "embed_vd": embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                   device=device),
        "final_norm_d": torch.zeros((cfg.d_model,), device=device),
    }
    params["layers"] = stack("layers", cfg.num_layers,
                             cross_attention=cfg.encoder_layers > 0)
    if not cfg.tie_embeddings:
        params["unembed_vd"] = embedding_init(gen, cfg.padded_vocab,
                                              cfg.d_model, device=device)
    if cfg.encoder_layers:
        params["enc_layers"] = stack("enc_layers", cfg.encoder_layers)
        params["enc_norm_d"] = torch.zeros((cfg.d_model,), device=device)
    if cfg.vision_tokens:
        params["vproj_dh"] = dense_init(gen, cfg.vision_dim, cfg.d_model,
                                        device=device)
    return params


def layer_trees(layers: Any, n: int) -> List[Any]:
    """The ``n`` per-layer trees of the stacked layer tree: each tensor
    leaf split once with ``torch.unbind`` (under autograd its backward
    stacks the layers' gradients once, where indexing each layer would
    write a zero tensor the size of the whole leaf per layer), each
    per-layer list (plans) taken as it is."""
    if isinstance(layers, dict):
        parts = {k: layer_trees(v, n) for k, v in layers.items()}
        return [{k: part[i] for k, part in parts.items()} for i in range(n)]
    if isinstance(layers, list):
        return layers
    return list(torch.unbind(layers))


def _vocab_mask(cfg: ModelConfig, logits: torch.Tensor, offset: int = 0
                ) -> torch.Tensor:
    """Mask padded-vocab logits with -1e30 (an elementwise add).
    ``logits`` holds the vocab ids from ``offset`` on (a vocab-parallel
    rank's block), else all of them."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(offset, offset + logits.shape[-1],
                       device=logits.device) >= cfg.vocab_size
    # Python scalars (float32 by the default dtype), no host->device copy
    bias = torch.where(pad, -1e30, 0.0)
    return logits + bias.to(logits.dtype)


def _windows(cfg: ModelConfig) -> List[int]:
    return [cfg.layer_window(i) for i in range(cfg.num_layers)]


def table_name(cfg: ModelConfig) -> str:
    """The unembedding's leaf: the embedding table when it is tied."""
    return "embed_vd" if cfg.tie_embeddings else "unembed_vd"


def _table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params[table_name(cfg)]


def _mix(outs: List[torch.Tensor]) -> torch.Tensor:
    return outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
         aux: Optional[dict]) -> torch.Tensor:
    """The layer's feed-forward block: MoE (router losses into ``aux``)
    or the MLP."""
    if cfg.is_moe:
        return moe_apply(p["moe"], x, cfg.experts_per_token, aux)
    return mlp_apply(p["mlp"], x, cfg.activation)


# ---------------------------------------------------------------------------
# forward (training) / encoder
# ---------------------------------------------------------------------------
def _decoder_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, window: int, prefix_len: int = 0,
                   enc_out: Optional[torch.Tensor] = None,
                   causal: bool = True) -> Tuple[torch.Tensor, dict]:
    aux: dict = {}
    h = rms_norm(x, p["ln1_d"], cfg.norm_eps)
    outs = []
    if cfg.block_type in ("attn", "hybrid"):
        outs.append(attn.attention_block(
            p["attn"], h, positions, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.rope_theta, window=window, causal=causal,
            norm_eps=cfg.norm_eps, block=cfg.attn_block,
            blockwise_threshold=cfg.blockwise_threshold,
            prefix_len=prefix_len, backend=cfg.attn_backend))
    if cfg.block_type in ("ssm", "hybrid"):
        outs.append(ssm_mod.ssm_apply(
            p["ssm"], h, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim,
            cfg.ssm_groups, backend=cfg.ssd_backend, chunk=cfg.ssd_chunk))
    x = x + _mix(outs)
    if enc_out is not None:
        h = rms_norm(x, p["lnx_d"], cfg.norm_eps)
        x = x + attn.cross_attention_block(
            p["xattn"], h, enc_out, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim)
    if "ln2_d" in p:
        h = rms_norm(x, p["ln2_d"], cfg.norm_eps)
        x = x + _ffn(cfg, p, h, aux)
    return x, aux


def _stack(cfg: ModelConfig, layers: Params, x: torch.Tensor,
           positions: torch.Tensor, prefix_len: int,
           enc_out: Optional[torch.Tensor], causal: bool = True,
           num_layers: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """The layers of a stack in order: the decoder's (its per-layer
    windows) or, with ``num_layers``, the encoder's (window 0 on every
    layer); the MoE router losses summed over the layers."""
    windows = _windows(cfg) if num_layers is None else [0] * num_layers
    lb, z = 0.0, 0.0
    for lp, window in zip(layer_trees(layers, len(windows)), windows):
        if cfg.remat:
            x, aux = checkpoint(_decoder_layer, cfg, lp, x, positions,
                                window, prefix_len, enc_out, causal,
                                use_reentrant=False)
        else:
            x, aux = _decoder_layer(cfg, lp, x, positions, window,
                                    prefix_len, enc_out, causal)
        lb = lb + aux.get("moe_lb_loss", 0.0)
        z = z + aux.get("moe_z_loss", 0.0)
    return x, {"moe_lb_loss": lb, "moe_z_loss": z}


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """The whisper encoder: ``frames`` are stub embeddings (B, S_enc,
    d_model), taken in the parameters' dtype; bidirectional attention
    (``causal=False``), window 0 on every layer, ``cfg.attn_backend`` as
    the decoder's forward takes it."""
    x = frames.to(params["enc_norm_d"].dtype)
    x, _ = _stack(cfg, params["enc_layers"], x, _positions(x), 0, None,
                  causal=False, num_layers=cfg.encoder_layers)
    return rms_norm(x, params["enc_norm_d"], cfg.norm_eps)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Token embeddings, with the VLM's projected patches before them;
    returns (x, positions, prefix_len), prefix_len the patch count (0
    without patches). Under sharded training a split ``vproj_dh`` gives
    the gathered columns; a whole leaf is a plain float matmul."""
    x = embed(params["embed_vd"], batch["tokens"], "embed_vd")
    prefix_len = 0
    if cfg.vision_tokens and "patches" in batch:
        xv = proj(batch["patches"], params["vproj_dh"], "vproj_dh")
        x = torch.cat([xv.to(x.dtype), x], dim=1)
        prefix_len = batch["patches"].shape[1]
    return x, _positions(x), prefix_len


def _encoder_output(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
                    ) -> Optional[torch.Tensor]:
    return encode(params, cfg, batch["frames"]) if cfg.encoder_layers \
        else None


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, dict]:
    """Training forward. batch: tokens (B, S) [+ patches (B, P, vision_dim)
    | frames (B, S_enc, d_model)]. Returns (logits (B, P + S, V), aux);
    aux holds the MoE router losses summed over the decoder's layers (0.0
    without MoE layers), as in the JAX package. Under sharded training
    the logits are this rank's block of the vocab where the table is
    split (``layers.vocab_shard`` of the table gives its offset)."""
    check_supported(cfg)
    x, positions, prefix_len = _embed_inputs(params, cfg, batch)
    enc_out = _encoder_output(params, cfg, batch)
    x, aux = _stack(cfg, params["layers"], x, positions, prefix_len, enc_out)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    name = table_name(cfg)
    shard = vocab_shard(params[name], name)
    logits = _vocab_mask(cfg, unembed(params[name], x, name),
                         0 if shard is None else shard[2])
    return logits, aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """KV cache (L, B, S, kv, hd) in ``dtype`` for attention layers; SSM
    state (L, B, H, N, P) and conv tails (L, B, CONV_K-1, conv) in f32;
    with an encoder, the cross-attention's K/V ``xk``/``xv`` (L, B,
    enc_len, kv, hd) in ``dtype``."""
    check_supported(cfg)
    cache: Dict[str, torch.Tensor] = {}
    l = cfg.num_layers
    if cfg.block_type in ("attn", "hybrid"):
        cache.update(attn.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                        cfg.head_dim, dtype, layers=l,
                                        device=device))
    if cfg.block_type in ("ssm", "hybrid"):
        _, nheads, conv_dim = ssm_mod.ssm_dims(
            cfg.d_model, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim,
            cfg.ssm_groups)
        cache["state"] = torch.zeros((l, batch, nheads, cfg.ssm_state,
                                      cfg.ssm_head_dim), device=device)
        cache["conv_tail"] = torch.zeros((l, batch, ssm_mod.CONV_K - 1,
                                          conv_dim), device=device)
    if cfg.encoder_layers:
        xkv = attn.init_kv_cache(batch, enc_len, cfg.num_kv_heads,
                                 cfg.head_dim, dtype, layers=l, device=device)
        cache["xk"], cache["xv"] = xkv["k"], xkv["v"]
    return cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int, cache_dtype=torch.bfloat16,
            logits_index: Optional[Union[int, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the prompt (batch: tokens [+ patches | frames], as
    :func:`forward` takes it) and build the cache sized to ``max_len``
    positions, which count the VLM's prefix. Returns (logits (B, V) at the
    last position, or at ``logits_index``, and the cache).

    As in the JAX package, the decoder's attention here runs the default
    ``"jnp"`` backend whatever ``cfg.attn_backend`` says (the encoder
    passes it on, as :func:`encode` does); the SSM layers run
    ``cfg.ssd_backend`` (one SSD scan per SSM layer)."""
    x, positions, prefix_len = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if max_len < s:
        raise ValueError(f"cache max_len={max_len} < prompt length {s} "
                         f"(includes {prefix_len} prefix tokens)")
    enc_out = _encoder_output(params, cfg, batch)
    cache = init_cache(cfg, b, max_len,
                       enc_len=0 if enc_out is None else enc_out.shape[1],
                       dtype=cache_dtype, device=x.device)
    layers = layer_trees(params["layers"], cfg.num_layers)
    for i, (lp, window) in enumerate(zip(layers, _windows(cfg))):
        h = rms_norm(x, lp["ln1_d"], cfg.norm_eps)
        outs = []
        if cfg.block_type in ("attn", "hybrid"):
            out, (k, v) = attn.attention_block(
                lp["attn"], h, positions, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.rope_theta, window=window, causal=True,
                norm_eps=cfg.norm_eps, block=cfg.attn_block,
                blockwise_threshold=cfg.blockwise_threshold,
                prefix_len=prefix_len, return_kv=True)
            outs.append(out)
            cache["k"][i, :, :s] = k.to(cache_dtype)
            cache["v"][i, :, :s] = v.to(cache_dtype)
        if cfg.block_type in ("ssm", "hybrid"):
            out, (state, tail) = ssm_mod.ssm_apply(
                lp["ssm"], h, cfg.ssm_state, cfg.ssm_expand,
                cfg.ssm_head_dim, cfg.ssm_groups, backend=cfg.ssd_backend,
                chunk=cfg.ssd_chunk, return_state=True)
            outs.append(out)
            cache["state"][i] = state
            cache["conv_tail"][i] = tail
        x = x + _mix(outs)
        if enc_out is not None:
            h = rms_norm(x, lp["lnx_d"], cfg.norm_eps)
            out, (xk, xv) = attn.cross_attention_block(
                lp["xattn"], h, enc_out, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, return_kv=True)
            x = x + out
            cache["xk"][i] = xk.to(cache_dtype)
            cache["xv"][i] = xv.to(cache_dtype)
        if "ln2_d" in lp:
            h = rms_norm(x, lp["ln2_d"], cfg.norm_eps)
            x = x + _ffn(cfg, lp, h, None)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    logits = _vocab_mask(cfg, unembed(_table(params, cfg),
                                      _row(x, logits_index)))[:, 0]
    return logits, cache


def _row(x: torch.Tensor, index: Optional[Union[int, torch.Tensor]]
         ) -> torch.Tensor:
    """Position ``index`` of (B, S, D) activations as (B, 1, D): the last
    position by default. A tensor index is read on the device with
    ``index_select`` (no host sync) into a buffer with the strides of a
    slice of ``x``: the unembedding's matmul picks its path by layout,
    and a contiguous row would round differently from the slice an int
    index gives."""
    if index is None:
        return x[:, -1:, :]
    if torch.is_tensor(index):
        row = torch.empty_like(x)[:, :1]
        row.copy_(x.index_select(1, index.reshape(1).to(
            device=x.device, dtype=torch.int64)))
        return row
    return x[:, int(index):int(index) + 1, :]


def token_stop_mask(tokens: torch.Tensor, stop_tokens) -> torch.Tensor:
    """Per-row stop detection on the device. tokens: (...,) int token ids;
    stop_tokens: (K,) stop set (K == 0 never stops), a tensor (the
    serving engine's, already on the device: no copy) or host ints (one
    host-to-device copy). Returns a boolean tensor of tokens' shape."""
    if torch.is_tensor(stop_tokens):
        stop = stop_tokens.to(device=tokens.device, dtype=torch.int32)
    else:
        # repro-lint: disable=RPR101 (host ints; the engine passes a tensor)
        stop = torch.as_tensor(stop_tokens, dtype=torch.int32,
                               device=tokens.device)
    if stop.dim() != 1:
        raise ValueError(f"stop_tokens must be 1-D, got {tuple(stop.shape)}")
    if stop.shape[0] == 0:
        return torch.zeros(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    return (tokens[..., None].to(torch.int32) == stop).any(dim=-1)


def prefill_chunk(params: Params, cfg: ModelConfig,
                  cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                  start: Union[int, torch.Tensor],
                  logits_index: Optional[Union[int, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill: a block of ``c`` prompt tokens at position offset
    ``start`` against an existing cache. tokens: (B, c); start: the first
    token's position, a Python int shared by the batch or a per-row (B,)
    tensor. The chunk's K/V land at positions start + [0, c), written
    into the cache in place; each query attends the whole cache under
    per-position causal validity, so a prompt run chunk by chunk into a
    compute-dtype scratch cache of the whole prefill's length gives the
    whole prefill's first token and K/V (masked entries contribute
    exactly 0.0). Returns (logits (B, V) at in-chunk position
    ``logits_index``, default the last, and the cache).

    Attention-only decoders: chunk resume carries no state besides the
    KV cache; SSM, hybrid, encoder and VLM configs raise."""
    if cfg.block_type != "attn" or cfg.encoder_layers or cfg.vision_tokens:
        raise NotImplementedError(
            "chunked prefill supports attention-only decoders "
            f"(got block_type={cfg.block_type!r})")
    x = embed(params["embed_vd"], tokens)
    layers = layer_trees(params["layers"], cfg.num_layers)
    for i, (lp, window) in enumerate(zip(layers, _windows(cfg))):
        h = rms_norm(x, lp["ln1_d"], cfg.norm_eps)
        out, _ = attn.decode_attention(
            lp["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, start,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rope_theta,
            window=window, norm_eps=cfg.norm_eps)
        x = x + out
        if "ln2_d" in lp:
            h = rms_norm(x, lp["ln2_d"], cfg.norm_eps)
            x = x + _ffn(cfg, lp, h, None)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    logits = _vocab_mask(cfg, unembed(_table(params, cfg),
                                      _row(x, logits_index)))[:, 0]
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], token: torch.Tensor,
                index: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. token: (B, 1); index: the current position (the
    VLM's prefix counts), a Python int shared by the batch or a (B,)
    per-row tensor. The cache is updated in place and returned; an
    encoder-decoder's cross-attention reads the encoder K/V prefill
    stored. Returns (logits (B, V), cache)."""
    x = embed(params["embed_vd"], token)
    layers = layer_trees(params["layers"], cfg.num_layers)
    for i, (lp, window) in enumerate(zip(layers, _windows(cfg))):
        h = rms_norm(x, lp["ln1_d"], cfg.norm_eps)
        outs = []
        if cfg.block_type in ("attn", "hybrid"):
            out, _ = attn.decode_attention(
                lp["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
                index, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.rope_theta, window=window, norm_eps=cfg.norm_eps)
            outs.append(out)
        if cfg.block_type in ("ssm", "hybrid"):
            out, st = ssm_mod.ssm_step(
                lp["ssm"], h, {"state": cache["state"][i],
                               "conv_tail": cache["conv_tail"][i]},
                cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim,
                cfg.ssm_groups)
            outs.append(out)
            cache["state"][i] = st["state"]
            cache["conv_tail"][i] = st["conv_tail"]
        x = x + _mix(outs)
        if cfg.encoder_layers:
            h = rms_norm(x, lp["lnx_d"], cfg.norm_eps)
            x = x + attn.cross_attention_decode(
                lp["xattn"], h, cache["xk"][i], cache["xv"][i],
                cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        if "ln2_d" in lp:
            h = rms_norm(x, lp["ln2_d"], cfg.norm_eps)
            x = x + _ffn(cfg, lp, h, None)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    logits = _vocab_mask(cfg, unembed(_table(params, cfg), x))[:, 0]
    return logits, cache
