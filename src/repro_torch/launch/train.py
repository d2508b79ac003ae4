"""LM training (counterpart of ``repro/launch/train.py``): the LM loss,
the train step, state construction, the mesh-sharding helpers and the
main loop with checkpoint/restart and optional int8 gradient
compression, on one device or on a (data, model) mesh.

The attention of every layer runs ``cfg.attn_backend``: with ``"cuda"``
each layer's forward and backward launch the hand-written flash-attention
kernels. The other matmuls are plain float32 ``torch.matmul`` (in the
JAX package, XLA's). The state is a dict ``{"params", "opt": AdamWState,
"step"[, "grad_err"]}`` of the JAX package's structure, so checkpoints
cross between the packages; the optimizer updates it in place.

Sharded training (``make_train_step(..., mesh=)``, ``train_loop(mesh=)``,
``--mesh DP,TP``) runs the step as SPMD ranks, one process per rank, over
a :class:`~repro_torch.launch.mesh.Mesh`. Each rank stores its slices of
the state as :func:`state_shardings` gives them (the JAX package's
``param_spec_for_path`` + :func:`fit_spec` table: ``_dh`` columns, ``_hd``
rows, ``_vd`` vocab rows, ``_bh`` and the expert stacks split over
``model`` where the dimension divides; everything else whole), takes its
block of the batch where the data axes divide it (:func:`batch_shardings`;
else the whole batch), and runs the model under a training
``ShardingContext``: activations stay split between a column split and its
row split, the loss is a vocab-parallel cross-entropy, the gradients are
averaged over the data ranks, and the clip's norm and the compression's
scales are those of the whole leaves. It computes what the single-device
step computes, within float32 rounding; replicated leaves end every step
bit-identical across the model axis.

Run (reduced, on the CPU; on the card drop ``--layers/--d-model/--device``
for full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --layers 2 --d-model 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --batch 2 --seq 2048 --steps 4 --attn-backend cuda
On a 2x2 mesh of CPU ranks, and on a 1x2 mesh of two ranks sharing the
card (gloo; ``nccl`` where each rank has a card of its own):
  OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --arch gemma3-1b \
      --layers 2 --d-model 64 --device cpu --mesh 2,2
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
      repro_torch.launch.train --arch gemma3-1b --batch 2 --seq 2048 \
      --steps 4 --attn-backend cuda --mesh 1,2
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import (cleanup_old, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import DataConfig, LMDataIterator
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (DATA_AXES, PartitionSpec as P,
                                              ShardingContext,
                                              logical_rules,
                                              param_spec_for_path,
                                              split_dims, use_sharding)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import vocab_shard
from repro_torch.models.lm import forward, init_lm, table_name
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.optim.compression import (compress_grads, decompress_grads,
                                           init_error_state)
from repro_torch.tree import (flatten_with_path, leaves, tree_map,
                              unflatten_like)

PyTree = Any


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the text positions (the VLM's
    prefix positions' logits are dropped), plus the MoE router losses for
    MoE configs (``1e-2 * lb + 1e-3 * z``, with ``moe_lb`` among the
    metrics), as in the JAX package. The target logit is taken with
    ``torch.gather``: the JAX package contracts a one-hot over the vocab
    (shard-friendly there), which gives the same value, one product by 1
    plus exact zeros, but would add a (B*S, V) float32 tensor here. Under
    sharded training the cross-entropy is vocab-parallel."""
    logits, aux = forward(params, cfg, batch)
    if cfg.vision_tokens and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:, :]   # text positions
    name = table_name(cfg)
    nll = cross_entropy(logits, batch["targets"],
                        vocab_shard(params[name], name))
    metrics = {"loss": nll}
    loss = nll
    if cfg.is_moe:
        loss = loss + 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        metrics["moe_lb"] = aux["moe_lb_loss"]
    return loss, metrics


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  shard=None) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[target], in float32.

    ``shard`` (``layers.vocab_shard``: mesh, axis, first vocab id) makes it
    vocab-parallel over ``logits``, this rank's block of the vocab: a
    global max, a summed ``exp`` and a masked target pick, each reduced
    over the axis; the whole logits are never gathered."""
    logits = logits.to(torch.float32)
    if shard is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return (lse - tgt).mean()
    mesh, axis, first = shard
    top = coll.all_reduce_max(logits.detach().amax(dim=-1), mesh, axis)
    total = coll.reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1),
                             mesh, axis)
    lse = torch.log(total) + top
    local = targets.long() - first
    mine = (local >= 0) & (local < logits.shape[-1])
    pick = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    tgt = coll.reduce_from(torch.where(mine, pick, torch.zeros_like(pick)),
                           mesh, axis)
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
# sharded state construction
# ---------------------------------------------------------------------------
def fit_spec(mesh, spec: P, shape) -> P:
    """Drop the split on any dimension the mesh axes do not divide evenly
    (as the JAX package does for pjit, whose shardings need exact
    divisibility: batch-1 decode, head counts below the model axis)."""
    out = []
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape) -
                                                      len(tuple(spec)))):
        if axes is None:
            out.append(None)
            continue
        size = mesh.size(axes)
        out.append(axes if shape[i] % size == 0 else None)
    return P(*out)


def _keys(path) -> List[str]:
    """A flatten path's keys as names (``d:'wq_dh'`` -> ``wq_dh``)."""
    return [k.split(":", 1)[1].strip("'") for k in path]


def _leaf_spec(mesh, rules, path, leaf) -> P:
    keys = _keys(path)
    stacked = any(k in ("layers", "enc_layers") for k in keys)
    name = ("s_" if stacked else "") + keys[-1]
    return fit_spec(mesh, param_spec_for_path(name, rules),
                    tuple(leaf.shape))


def tree_specs(mesh, tree: PyTree) -> List[P]:
    """The spec of every leaf of a global (params or state) tree, in
    flatten order: the parameter table by leaf name, so the moments and
    the error state split like the params and step counters stay
    whole."""
    rules = logical_rules(mesh)
    return [_leaf_spec(mesh, rules, path, leaf)
            for path, leaf in flatten_with_path(tree)]


def param_shardings(mesh, params_template: PyTree) -> PyTree:
    """``params_template``'s structure with each leaf's spec."""
    return unflatten_like(params_template, tree_specs(mesh, params_template))


def state_shardings(mesh, state_template: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of a train state: params as :func:`param_shardings`, the
    AdamW moments and the error state split like them, steps whole."""
    ps = param_shardings(mesh, state_template["params"])
    out: Dict[str, Any] = {"params": ps, "step": P()}
    if "opt" in state_template:
        out["opt"] = AdamWState(step=P(), mu=ps, nu=ps)
    if "grad_err" in state_template:
        out["grad_err"] = ps
    return out


def batch_shardings(mesh, batch_template: Dict[str, Any]) -> Dict[str, P]:
    """Each batch leaf's spec: the leading dimension over the data axes
    where they divide it."""
    b = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return {k: fit_spec(mesh, P(b, *((None,) * (v.dim() - 1))),
                        tuple(v.shape))
            for k, v in batch_template.items()}


def _local(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    for d, axes in split_dims(mesh, spec):
        t = coll.local_block(t, mesh, axes, d)
    return t


def shard_state(state: PyTree, mesh) -> PyTree:
    """This rank's slices of a global state (or params) tree, as
    :func:`tree_specs` splits it: each split leaf a contiguous copy of its
    own, each whole leaf the input's own tensor (a step that updates the
    result in place updates those leaves of ``state`` too)."""
    return unflatten_like(state, [
        _local(t, mesh, spec).clone() if split_dims(mesh, spec) else t
        for t, spec in zip(leaves(state), tree_specs(mesh, state))])


def gather_state(state: PyTree, mesh, template: PyTree) -> PyTree:
    """The global leaves of a sharded tree (collective: every rank calls
    it). ``template`` has the global shapes (e.g. :func:`state_template`
    on the meta device)."""
    out = []
    for t, spec in zip(leaves(state), tree_specs(mesh, template)):
        for d, axes in split_dims(mesh, spec):
            t = coll.all_gather(t, mesh, axes, d)
        out.append(t)
    return unflatten_like(state, out)


def param_template(cfg: ModelConfig) -> PyTree:
    """The global parameter tree's shapes, on the meta device (no
    storage)."""
    return init_lm(cfg, torch.Generator(), device="meta")


def state_template(cfg: ModelConfig, compress_bits: int = 0
                   ) -> Dict[str, Any]:
    """A global train state's structure and shapes, on the meta device."""
    params = param_template(cfg)
    out = {"params": params, "opt": adamw_init(params),
           "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if compress_bits:
        out["grad_err"] = init_error_state(params)
    return out


def split_table(mesh, params_template: PyTree) -> Dict[Tuple[str, tuple], P]:
    """The ``ShardingContext.splits`` of a parameter tree: (leaf name,
    local per-layer shape) -> per-layer spec of every leaf stored split.
    Raises when two leaves of one name would share a local shape with
    different splits (the model's call sites could not tell them
    apart). Cross-attention's leaves (``xattn``) and an encoder's
    (``enc_layers``) share names, local shapes and specs with the
    decoder's self-attention and MLP, so one entry serves them all."""
    table: Dict[Tuple[str, tuple], P] = {}
    whole = set()
    for (path, leaf), spec in zip(flatten_with_path(params_template),
                                  tree_specs(mesh, params_template)):
        keys = _keys(path)
        stacked = any(k in ("layers", "enc_layers") for k in keys)
        shape = list(leaf.shape)
        for d, axes in split_dims(mesh, spec):
            shape[d] //= mesh.size(axes)
        if stacked:
            shape, spec = shape[1:], P(*tuple(spec)[1:])
        key = (keys[-1], tuple(shape))
        if split_dims(mesh, spec):
            if table.setdefault(key, spec) != spec:
                raise ValueError(f"leaves named {keys[-1]!r} of local shape "
                                 f"{tuple(shape)} split differently")
        else:
            whole.add(key)
    clash = whole & set(table)
    if clash:
        raise ValueError(f"leaves {sorted(clash)} are split in one place "
                         "and whole in another at the same local shape")
    return table


def leaf_splits(mesh, params_template: PyTree) -> coll.LeafSplits:
    """Which parameter leaves (flatten order) are stored split over
    ``model``."""
    return coll.LeafSplits(mesh, "model", tuple(
        bool(split_dims(mesh, spec))
        for spec in tree_specs(mesh, params_template)))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def sharded_loss_and_grads(cfg: ModelConfig, mesh):
    """``fn(params, batch) -> (loss, metrics, grads)``: this rank's part
    of :func:`loss_and_grads` on ``mesh``. ``params`` are this rank's
    slices, ``batch`` the global batch (every rank passes the same one;
    each takes its block where the data axes divide it). The gradients
    are this rank's slices of the whole batch's gradient (averaged over
    the data ranks) and the loss is the global one. ``fn.splits`` marks
    the leaves stored split over ``model``. The encoder-decoder's and
    the VLM's batch entries (``frames``, ``patches``) split with the
    tokens."""
    template = param_template(cfg)
    table = split_table(mesh, template)

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        axes = batch_shardings(mesh, batch)["tokens"][0]
        axes = () if axes is None else (axes,) if isinstance(axes, str) \
            else tuple(axes)
        if axes:
            batch = {k: coll.local_block(v, mesh, axes, 0)
                     for k, v in batch.items()}
        with use_sharding(ShardingContext(mesh, table, axes)):
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        if axes:            # the mean over the data ranks' batches
            n = mesh.size(axes)
            mean = lambda t: coll.all_reduce_sum(t, mesh, axes) / n
            grads = tree_map(mean, grads)
            loss = metrics["loss"] = mean(metrics["loss"])
        return loss, metrics, grads

    fn.splits = leaf_splits(mesh, template)
    return fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress_bits: int = 0, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: gradients, the
    optional compress/decompress round trip with error feedback, and an
    AdamW update in place. metrics: loss, grad_norm, lr (device
    tensors).

    With ``mesh`` the step is this rank's part of the sharded step:
    ``state`` holds this rank's slices (:func:`shard_state`), ``batch`` is
    the global batch (every rank passes the same one) and the metrics are
    the global step's."""
    grads_fn = None if mesh is None else sharded_loss_and_grads(cfg, mesh)
    splits = None if mesh is None else grads_fn.splits

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if grads_fn is None:
            _, metrics, grads = loss_and_grads(state["params"], cfg, batch)
        else:
            _, metrics, grads = grads_fn(state["params"], batch)
        if compress_bits:
            codes, scales, err = compress_grads(grads, state.get("grad_err"),
                                                compress_bits, splits)
            grads = decompress_grads(codes, scales)
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state["opt"],
                                                state["params"], splits)
        new_state = dict(state, params=params, opt=opt,
                         step=state["step"] + 1)
        if compress_bits:
            new_state["grad_err"] = err
        return new_state, dict(metrics, **opt_metrics)

    return train_step


def init_state(cfg: ModelConfig, seed: int = 0,
               param_dtype: torch.dtype = torch.float32, device=None,
               mesh=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (``None`` -> CUDA),
    zero AdamW moments, step 0. With ``mesh``, this rank's slices: every
    rank draws the whole parameters and keeps its slices before the
    moments are made."""
    params = init_lm(cfg, seed, device=device)
    if param_dtype != torch.float32:
        params = unflatten_like(params, [p.to(param_dtype)
                                         for p in leaves(params)])
    if mesh is not None:
        params = shard_state(params, mesh)
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
               attn_backend: Optional[str] = None,
               mesh=None) -> Dict[str, float]:
    """Train ``arch`` (reduced when ``layers`` or ``d_model`` is given)
    for ``steps`` steps; resume from ``ckpt_dir``'s latest checkpoint if
    there is one. ``device=None`` means CUDA; ``attn_backend=None`` keeps
    the config's. ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` or a
    ``"dp,tp"`` spec, one process per rank) trains sharded: checkpoints
    hold the global leaves, written by rank 0, and rank 0 prints. Returns
    the first and last logged losses."""
    cfg = get_config(arch)
    if layers or d_model:
        cfg = cfg.reduced(num_layers=layers or 2, d_model=d_model or 64,
                          vocab=min(cfg.vocab_size, 512))
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    if isinstance(mesh, str):
        mesh = make_mesh(mesh, device, module="repro_torch.launch.train")
    dev = resolve_device(device) if mesh is None else mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(1, steps // 20))
    state = init_state(cfg, 0, device=dev, mesh=mesh)
    if compress_bits:
        state["grad_err"] = init_error_state(state["params"])
    ckpt_mesh = {} if mesh is None else dict(
        mesh=mesh, specs=tree_specs(mesh, state_template(cfg,
                                                         compress_bits)))

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch)
    it = LMDataIterator(data_cfg, cfg)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start, extras = restore_checkpoint(ckpt_dir, state,
                                                  **ckpt_mesh)
        it.restore(extras.get("data_step", start))
        say(f"[train] resumed from step {start}")
    if mesh is not None:
        say(f"[train] mesh {mesh.shape['data']},{mesh.shape['model']} over "
            f"{mesh.size(mesh.axis_names)} ranks, backend {mesh.backend}")

    step_fn = make_train_step(cfg, opt_cfg, compress_bits, mesh)
    metrics_hist = []
    t0 = time.time()
    for step in range(start, steps):
        state, metrics = step_fn(state, batch_to_device(next(it), dev))
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            metrics_hist.append(loss)
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"({time.time() - t0:.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state,
                            extras={"data_step": it.state()}, **ckpt_mesh)
            if mesh is None or mesh.rank == 0:
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
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="train on a (data, model) mesh of DP*TP ranks, one "
                         "process per rank (launch with torchrun)")
    args = ap.parse_args()
    res = train_loop(args.arch, args.steps, args.batch, args.seq,
                     args.layers, args.d_model, args.ckpt_dir,
                     args.ckpt_every, args.compress_bits, args.lr,
                     device=args.device, attn_backend=args.attn_backend,
                     mesh=args.mesh)
    if not torch.distributed.is_initialized() or \
            torch.distributed.get_rank() == 0:
        print(f"[train] loss {res['first_loss']:.4f} -> "
              f"{res['last_loss']:.4f}")


if __name__ == "__main__":
    main()
