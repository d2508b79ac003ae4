"""The LM stack for the dense, SSM and hybrid architectures (counterpart
of ``repro/models/lm.py``).

One parameterized decoder covering dense GQA/MQA attention (qk-norm, QKV
bias, sliding windows, RoPE), Mamba2 SSD layers and hymba-style parallel
attention + SSM blocks. Layer parameters are stacked along a leading
layer axis, as in the JAX package, and the layers run as a Python loop
over it (:func:`layer_trees` splits every stacked leaf once per call with
``torch.unbind``; a leaf that is a list, such as the per-layer plans of
``plan_params_for_pim``, gives its entries). Per-layer sliding windows
are Python ints, so ``forward`` with ``attn_backend="cuda"`` reaches the
flash-attention kernel (forward and backward), which JAX's scan over a
traced window array never does. ``prefill`` passes no backend, as in the
JAX package. ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``), the counterpart of ``jax.checkpoint``.

Not ported yet, and raising: MoE FFNs (ROADMAP A6, ``models/moe.py``),
the encoder-decoder with cross-attention (whisper) and the VLM prefix
(paligemma), and chunked prefill (ROADMAP A7).

API:
  init_lm(cfg, gen, device)                   -> params
  forward(params, cfg, batch)                 -> logits, aux
  prefill(params, cfg, batch, max_len)        -> logits, cache
  decode_step(params, cfg, cache, token, idx) -> logits, cache
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, embed, embedding_init,
                                       mlp_apply, mlp_init, rms_norm,
                                       unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the JAX LM stack the port does not have."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP A6, "
            "models/moe.py)")
    if cfg.encoder_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder with cross-attention is not "
            "ported yet (ROADMAP A6, whisper)")
    if cfg.vision_tokens > 0:
        raise NotImplementedError(
            f"{cfg.name}: the VLM prefix is not ported yet (ROADMAP A6, "
            "paligemma)")
    if cfg.block_type not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown block_type {cfg.block_type!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p: Params = {"ln1_d": torch.zeros((cfg.d_model,), device=device)}
    if cfg.block_type in ("attn", "hybrid"):
        p["attn"] = attn.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias, device=device)
    if cfg.block_type in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.ssm_init(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
            cfg.ssm_head_dim, cfg.ssm_groups, device=device)
    if cfg.d_ff > 0:
        p["ln2_d"] = torch.zeros((cfg.d_model,), device=device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                            device=device)
    return p


def _stack_trees(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(cfg: ModelConfig, gen: Union[int, torch.Generator],
            device=None) -> Params:
    """Random parameters from ``gen`` (a ``torch.Generator`` on
    ``device``, or an int seed for one), layers stacked along a leading
    axis. ``device=None`` means CUDA."""
    check_supported(cfg)
    device = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    params: Params = {
        "embed_vd": embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                   device=device),
        "final_norm_d": torch.zeros((cfg.d_model,), device=device),
    }
    params["layers"] = _stack_trees([_init_layer(cfg, gen, device)
                                     for _ in range(cfg.num_layers)])
    if not cfg.tie_embeddings:
        params["unembed_vd"] = embedding_init(gen, cfg.padded_vocab,
                                              cfg.d_model, device=device)
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


def _vocab_mask(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Mask padded-vocab logits with -1e30 (an elementwise add)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= \
        cfg.vocab_size
    bias = torch.where(pad, torch.tensor(-1e30, device=logits.device),
                       torch.tensor(0.0, device=logits.device))
    return logits + bias.to(logits.dtype)


def _windows(cfg: ModelConfig) -> List[int]:
    return [cfg.layer_window(i) for i in range(cfg.num_layers)]


def _table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed_vd"] if cfg.tie_embeddings else \
        params["unembed_vd"]


def _mix(outs: List[torch.Tensor]) -> torch.Tensor:
    return outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------
def _decoder_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, window: int) -> torch.Tensor:
    h = rms_norm(x, p["ln1_d"], cfg.norm_eps)
    outs = []
    if cfg.block_type in ("attn", "hybrid"):
        outs.append(attn.attention_block(
            p["attn"], h, positions, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.rope_theta, window=window, causal=True,
            norm_eps=cfg.norm_eps, block=cfg.attn_block,
            blockwise_threshold=cfg.blockwise_threshold,
            backend=cfg.attn_backend))
    if cfg.block_type in ("ssm", "hybrid"):
        outs.append(ssm_mod.ssm_apply(
            p["ssm"], h, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim,
            cfg.ssm_groups, backend=cfg.ssd_backend, chunk=cfg.ssd_chunk))
    x = x + _mix(outs)
    if "ln2_d" in p:
        h = rms_norm(x, p["ln2_d"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.activation)
    return x


def _embed_inputs(params: Params, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens = batch["tokens"]
    x = embed(params["embed_vd"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, dict]:
    """Training forward. batch: tokens (B, S). Returns (logits (B, S, V),
    aux); aux holds the MoE losses of the JAX package, 0 here."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, batch)
    layers = layer_trees(params["layers"], cfg.num_layers)
    for lp, window in zip(layers, _windows(cfg)):
        if cfg.remat:
            x = checkpoint(_decoder_layer, cfg, lp, x, positions, window,
                           use_reentrant=False)
        else:
            x = _decoder_layer(cfg, lp, x, positions, window)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    logits = _vocab_mask(cfg, unembed(_table(params, cfg), x))
    return logits, {"moe_lb_loss": 0.0, "moe_z_loss": 0.0}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """KV cache (L, B, S, kv, hd) in ``dtype`` for attention layers; SSM
    state (L, B, H, N, P) and conv tails (L, B, CONV_K-1, conv) in f32."""
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
    return cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int, cache_dtype=torch.bfloat16,
            logits_index: Optional[Union[int, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the prompt and build the KV/SSM cache sized to
    ``max_len``. Returns (logits (B, V) at the last position, or at
    ``logits_index``, and the cache).

    As in the JAX package, attention here runs the default ``"jnp"``
    backend whatever ``cfg.attn_backend`` says; the SSM layers run
    ``cfg.ssd_backend`` (one SSD scan per SSM layer)."""
    x, positions = _embed_inputs(params, batch)
    b, s, _ = x.shape
    if max_len < s:
        raise ValueError(f"cache max_len={max_len} < prompt length {s}")
    cache = init_cache(cfg, b, max_len, dtype=cache_dtype, device=x.device)
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
                return_kv=True)
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
        if "ln2_d" in lp:
            h = rms_norm(x, lp["ln2_d"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.activation)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    if logits_index is None:
        x_last = x[:, -1:, :]
    else:
        j = int(logits_index)
        x_last = x[:, j:j + 1, :]
    logits = _vocab_mask(cfg, unembed(_table(params, cfg), x_last))[:, 0]
    return logits, cache


def token_stop_mask(tokens: torch.Tensor, stop_tokens) -> torch.Tensor:
    """Per-row stop detection on the device. tokens: (...,) int token ids;
    stop_tokens: (K,) stop set (K == 0 never stops). Returns a boolean
    tensor of tokens' shape."""
    stop = torch.as_tensor(stop_tokens, dtype=torch.int32,
                           device=tokens.device)
    if stop.dim() != 1:
        raise ValueError(f"stop_tokens must be 1-D, got {tuple(stop.shape)}")
    if stop.shape[0] == 0:
        return torch.zeros(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    return (tokens[..., None].to(torch.int32) == stop).any(dim=-1)


def decode_step(params: Params, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], token: torch.Tensor,
                index: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. token: (B, 1); index: the current position, a
    Python int shared by the batch or a (B,) per-row tensor. The cache is
    updated in place and returned. Returns (logits (B, V), cache)."""
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
        if "ln2_d" in lp:
            h = rms_norm(x, lp["ln2_d"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.activation)
    x = rms_norm(x, params["final_norm_d"], cfg.norm_eps)
    logits = _vocab_mask(cfg, unembed(_table(params, cfg), x))[:, 0]
    return logits, cache
