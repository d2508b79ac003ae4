"""LM training (counterpart of ``repro/launch/train.py``): the LM loss,
the train step, state construction and the main loop with
checkpoint/restart and optional int8 gradient compression, on one
device.

The attention of every layer runs ``cfg.attn_backend``: with ``"cuda"``
each layer's forward and backward launch the hand-written flash-attention
kernels. The other matmuls are plain float32 ``torch.matmul`` (in the
JAX package, XLA's). The state is a dict ``{"params", "opt": AdamWState,
"step"[, "grad_err"]}`` of the JAX package's structure, so checkpoints
cross between the packages; the optimizer updates it in place.

Not ported: the mesh-sharding helpers (``fit_spec``, ``param_shardings``,
``state_shardings``, ``batch_shardings``), which wait for ROADMAP A11.

Run (reduced, on the CPU; on the card drop ``--layers/--d-model/--device``
for full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --layers 2 --d-model 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --batch 2 --seq 2048 --steps 4 --attn-backend cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import (cleanup_old, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import DataConfig, LMDataIterator
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.lm import forward, init_lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import (compress_grads, decompress_grads,
                                           init_error_state)
from repro_torch.tree import leaves, unflatten_like

PyTree = Any


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy, plus the MoE router losses for MoE
    configs (``1e-2 * lb + 1e-3 * z``, with ``moe_lb`` among the metrics),
    as in the JAX package. The target logit is taken with
    ``torch.gather``: the JAX package contracts a one-hot over the vocab
    (shard-friendly there), which gives the same value, one product by 1
    plus exact zeros, but would add a (B*S, V) float32 tensor here."""
    logits, aux = forward(params, cfg, batch)
    nll = cross_entropy(logits, batch["targets"])
    metrics = {"loss": nll}
    loss = nll
    if cfg.is_moe:
        loss = loss + 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        metrics["moe_lb"] = aux["moe_lb_loss"]
    return loss, metrics


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[target], in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def loss_and_grads(params: PyTree, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, gradients in ``params``' structure); the
    counterpart of ``jax.value_and_grad(lm_loss, has_aux=True)``."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten_like(params, grads)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress_bits: int = 0):
    """``train_step(state, batch) -> (state, metrics)``: gradients, the
    optional compress/decompress round trip with error feedback, and an
    AdamW update in place. metrics: loss, grad_norm, lr (device
    tensors)."""
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        _, metrics, grads = loss_and_grads(state["params"], cfg, batch)
        if compress_bits:
            codes, scales, err = compress_grads(grads, state.get("grad_err"),
                                                compress_bits)
            grads = decompress_grads(codes, scales)
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state["opt"],
                                                state["params"])
        new_state = dict(state, params=params, opt=opt,
                         step=state["step"] + 1)
        if compress_bits:
            new_state["grad_err"] = err
        return new_state, dict(metrics, **opt_metrics)

    return train_step


def init_state(cfg: ModelConfig, seed: int = 0,
               param_dtype: torch.dtype = torch.float32, device=None
               ) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (``None`` -> CUDA),
    zero AdamW moments, step 0."""
    params = init_lm(cfg, seed, device=device)
    if param_dtype != torch.float32:
        params = unflatten_like(params, [p.to(param_dtype)
                                         for p in leaves(params)])
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def batch_to_device(np_batch: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}


# ---------------------------------------------------------------------------
# main loop (single process, one device)
# ---------------------------------------------------------------------------
def train_loop(arch: str, steps: int = 50, batch: int = 8, seq: int = 128,
               layers: Optional[int] = None, d_model: Optional[int] = None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               compress_bits: int = 0, lr: float = 3e-4,
               log_every: int = 10, device=None,
               attn_backend: Optional[str] = None) -> Dict[str, float]:
    """Train ``arch`` (reduced when ``layers`` or ``d_model`` is given)
    for ``steps`` steps; resume from ``ckpt_dir``'s latest checkpoint if
    there is one. ``device=None`` means CUDA; ``attn_backend=None`` keeps
    the config's. Returns the first and last logged losses."""
    cfg = get_config(arch)
    if layers or d_model:
        cfg = cfg.reduced(num_layers=layers or 2, d_model=d_model or 64,
                          vocab=min(cfg.vocab_size, 512))
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(1, steps // 20))
    state = init_state(cfg, 0, device=dev)
    if compress_bits:
        state["grad_err"] = init_error_state(state["params"])

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch)
    it = LMDataIterator(data_cfg, cfg)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start, extras = restore_checkpoint(ckpt_dir, state)
        it.restore(extras.get("data_step", start))
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, compress_bits)
    metrics_hist = []
    t0 = time.time()
    for step in range(start, steps):
        state, metrics = step_fn(state, batch_to_device(next(it), dev))
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            metrics_hist.append(loss)
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state,
                            extras={"data_step": it.state()})
            cleanup_old(ckpt_dir)
    return {"first_loss": metrics_hist[0], "last_loss": metrics_hist[-1]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-bits", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--attn-backend", default=None,
                    help="jnp or cuda (the flash-attention kernel); "
                         "default: the config's")
    args = ap.parse_args()
    res = train_loop(args.arch, args.steps, args.batch, args.seq,
                     args.layers, args.d_model, args.ckpt_dir,
                     args.ckpt_every, args.compress_bits, args.lr,
                     device=args.device, attn_backend=args.attn_backend)
    print(f"[train] loss {res['first_loss']:.4f} -> {res['last_loss']:.4f}")


if __name__ == "__main__":
    main()
