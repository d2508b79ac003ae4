"""Multi-pod dry-run: prove the distribution config is coherent, on meta
tensors (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) cell, on

  * the single-pod mesh 16x16 ('data', 'model')        = 256 ranks (``pod``)
  * the multi-pod mesh 2x16x16 ('pod', 'data', 'model') = 512 ranks
    (``multipod``)
  * or any ``"DP,TP"`` mesh, as the port's ``--mesh`` flags take it,

it checks the port's spec tables, counts what one rank holds and traces
one rank's step, and records the result in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``. Nothing is
allocated: every tensor is on the ``meta`` device, ``torch.distributed``
is never initialized, and no process is started.

A cell's record:

* **Coherence** (the counterpart of the reference's "it compiles"): every
  leaf's spec from :func:`~repro_torch.launch.train.param_shardings` /
  :func:`~repro_torch.launch.train.state_shardings` (``fit_spec``),
  :func:`~repro_torch.launch.train.batch_shardings` and
  :func:`cache_shardings` splits only dimensions its axes divide, and
  :func:`~repro_torch.launch.train.split_table` finds no conflict.
* **Per-rank bytes** (in place of the reference's ``memory_analysis``):
  the parameters (float32 templates cast to bf16, as the reference's
  ``_compile_cell`` casts them), the AdamW moments and step counters
  (train), the batch and the cache (prefill's output, decode's input), at
  the rank's local shapes. Even splits give every rank the same shapes,
  so the largest rank is any rank. ``state_f32`` is a train cell's
  state as the port's training holds it (float32 parameters).
* **FLOPs per rank**: the step, traced on meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode`` at one rank's local
  shapes. Train cells run the port's sharded step
  (``make_train_step(..., mesh=)``: this rank's shards, its block of the
  batch, the collectives of the split routes) with ``remat`` on, as the
  reference's train cells. The port's layers run as a Python loop, so the
  count is at full depth; the reference counts an unrolled 2- and 4-layer
  stack and extrapolates in L, because XLA's cost analysis counts a scan
  body once. This difference is deliberate. Prefill and decode are
  counted data-parallel, at the rank's block of the batch with whole
  parameters, and say so in ``flops_route``, since the port's model
  splits float weights in training only (its mesh serving splits
  programmed plans). Such a count is an upper bound on a model-split
  rank's.
* **Collective bytes by kind**: through a stand-in for
  ``torch.distributed`` inside :mod:`repro_torch.distributed.collectives`
  that leaves the right local shapes and logs each call's output bytes
  under the port's collective kinds (sums are all-gathers there).
* **Roofline terms** on the card's own rates (:data:`PEAK_FLOPS`,
  :data:`HBM_BW`, :data:`NVLINK_BW`). ``memory_s`` reads each byte of the
  rank's state, batch and cache once: a floor, where the reference uses
  XLA's bytes accessed.

MoE configs route by data, which meta tensors do not hold: their cells
assume a balanced assignment, T·k/E tokens per expert, and record it under
``"assumed"``. Decode takes its position as a Python int.

Shapes: train_4k (train step), prefill_32k, decode_32k, long_500k (decode;
sub-quadratic archs only).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh pod          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh 1,2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (DATA_AXES, PartitionSpec as P,
                                              split_dims)
from repro_torch.launch import train as train_mod
from repro_torch.models.lm import decode_step, init_cache, prefill
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves

SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

# the roofline's rates per card, from the published peaks
PEAK_FLOPS = 989e12    # dense bf16 FLOP/s, NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12       # HBM3 B/s, NVIDIA H100 80GB HBM3, 700 W
NVLINK_BW = 450e9      # NVLink B/s each way, NVIDIA H100 80GB HBM3, 700 W

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}

MOE_ASSUMPTION = "balanced routing: T*k/E tokens per expert"


# ---------------------------------------------------------------------------
# the mesh stand-in
# ---------------------------------------------------------------------------
class DryMesh:
    """A mesh's axes and sizes and one rank's coordinates, with no process
    group behind it: what the spec tables and the split routes read.
    ``group`` returns a token for axes that span ranks, so the
    collectives take their multi-rank branch (see
    :func:`recording_collectives`)."""

    def __init__(self, shape, axis_names, rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.coords: Dict[str, int] = {}
        r = rank
        for a in reversed(self.axis_names):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]

    @staticmethod
    def _axes(axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        axes = self._axes(axes)
        return None if self.size(axes) == 1 else ("dry", axes)

    @property
    def ranks(self) -> int:
        return math.prod(self.shape.values())


def make_dry_mesh(mesh_kind: str) -> DryMesh:
    """``"pod"``, ``"multipod"`` or a ``"DP,TP"`` string."""
    if mesh_kind in MESHES:
        return DryMesh(*MESHES[mesh_kind])
    try:
        dp, tp = (int(v) for v in mesh_kind.split(","))
    except ValueError:
        raise ValueError(f"mesh {mesh_kind!r}: expected pod, multipod or "
                         "DP,TP") from None
    return DryMesh((dp, tp), ("data", "model"))


class _DistStandIn:
    """``torch.distributed`` as the collectives module calls it, with no
    process group: the outputs keep their (meta) shapes and each call's
    output bytes are kept for :func:`recording_collectives`."""

    ReduceOp = dist.ReduceOp

    def __init__(self):
        self.last = 0

    def all_gather(self, parts, t, group=None):
        self.last = sum(p.nbytes for p in parts)

    def all_reduce(self, t, op=None, group=None):
        self.last = t.nbytes


@contextlib.contextmanager
def recording_collectives():
    """Within the block, the collectives of
    :mod:`repro_torch.distributed.collectives` run on the stand-in; yields
    a dict that collects the output bytes of each kind."""
    log: Dict[str, float] = {}
    stand_in = _DistStandIn()
    saved_dist, saved_run = coll.dist, coll._run

    def run(kind, t, fn):
        fn()
        log[kind] = log.get(kind, 0.0) + stand_in.last
        coll.COLLECTIVES[kind] += 1

    coll.dist, coll._run = stand_in, run
    try:
        yield log
    finally:
        coll.dist, coll._run = saved_dist, saved_run


# ---------------------------------------------------------------------------
# cells and their inputs (shapes and dtypes; meta tensors)
# ---------------------------------------------------------------------------
def cell_is_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture: no sub-quadratic path "
                       "for 524k context (DESIGN.md §4)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    """The step's inputs as meta tensors (shapes and dtypes, no
    storage)."""
    info = SHAPES[shape]
    s, b = info["seq_len"], info["global_batch"]
    kind = info["kind"]
    f32, i32 = torch.float32, torch.int32
    if kind == "train":
        if cfg.encoder_layers:                       # enc-dec split
            half = s // 2
            return {"tokens": _meta((b, half), i32),
                    "targets": _meta((b, half), i32),
                    "frames": _meta((b, half, cfg.d_model), f32)}
        if cfg.vision_tokens:
            text = s - cfg.vision_tokens
            return {"tokens": _meta((b, text), i32),
                    "targets": _meta((b, text), i32),
                    "patches": _meta((b, cfg.vision_tokens, cfg.vision_dim),
                                     f32)}
        return {"tokens": _meta((b, s), i32), "targets": _meta((b, s), i32)}
    if kind == "prefill":
        if cfg.encoder_layers:
            half = s // 2
            return {"tokens": _meta((b, half), i32),
                    "frames": _meta((b, half, cfg.d_model), f32)}
        if cfg.vision_tokens:
            return {"tokens": _meta((b, s - cfg.vision_tokens), i32),
                    "patches": _meta((b, cfg.vision_tokens, cfg.vision_dim),
                                     f32)}
        return {"tokens": _meta((b, s), i32)}
    # decode: one new token against a seq_len cache
    return {"token": _meta((b, 1), i32)}


def _cache_lengths(cfg: ModelConfig, shape: str) -> Tuple[int, int]:
    s = SHAPES[shape]["seq_len"]
    return (s // 2, s // 2) if cfg.encoder_layers else (s, 0)


def cache_specs(cfg: ModelConfig, shape: str,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The serving cache of the cell as meta tensors (``batch`` overrides
    the global batch)."""
    dec_len, enc_len = _cache_lengths(cfg, shape)
    b = SHAPES[shape]["global_batch"] if batch is None else batch
    return init_cache(cfg, b, dec_len, enc_len=enc_len, device="meta")


def cache_shardings(mesh, cfg: ModelConfig, cache_tpl, seq_shard: bool
                    ) -> Dict[str, P]:
    """Each cache leaf's spec, as the reference places the cache (the
    leading dim is the layer stack)."""
    b_axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    out = {}
    for name, leaf in cache_tpl.items():
        if name in ("k", "v", "xk", "xv"):
            kv_div = cfg.num_kv_heads % mesh.shape["model"] == 0
            if seq_shard:
                p = P(None, None, ("data", "model"), None, None)
            elif kv_div:
                p = P(None, b_axes, None, "model", None)
            else:
                p = P(None, b_axes, "model", None, None)
        elif name == "state":
            p = P(None, b_axes, "model", None, None)
        elif name == "conv_tail":
            p = P(None, b_axes, None, "model")
        else:
            p = P()
        out[name] = train_mod.fit_spec(mesh, p, tuple(leaf.shape))
    return out


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float,
                   chips: int) -> Dict[str, float]:
    return {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": bytes_hbm / (chips * HBM_BW),
        "collective_s": coll_bytes / (chips * NVLINK_BW),
    }


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """6·N_active·D for train; 2·N_active·D for forward-only shapes."""
    info = SHAPES[shape]
    # active params ~= embedding + layers (MoE: only routed top-k + shared)
    d = cfg.d_model
    per_layer = 0
    if cfg.block_type in ("attn", "hybrid"):
        per_layer += d * (cfg.num_heads + 2 * cfg.num_kv_heads) * \
            cfg.head_dim + cfg.num_heads * cfg.head_dim * d
    if cfg.block_type in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * d
        per_layer += 2 * d * d_inner + d_inner * d + \
            2 * d * cfg.ssm_groups * cfg.ssm_state
    if cfg.is_moe:
        per_layer += 3 * d * cfg.moe_d_ff * (cfg.experts_per_token +
                                             cfg.shared_experts)
    elif cfg.d_ff:
        per_layer += (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    n_active = cfg.num_layers * per_layer + cfg.vocab_size * d
    if cfg.encoder_layers:
        n_active += cfg.encoder_layers * per_layer
    if info["kind"] == "train":
        tokens = info["seq_len"] * info["global_batch"]
        return 6.0 * n_active * tokens
    if info["kind"] == "prefill":
        tokens = info["seq_len"] * info["global_batch"]
        return 2.0 * n_active * tokens
    return 2.0 * n_active * info["global_batch"]     # decode: 1 token/seq


# ---------------------------------------------------------------------------
# coherence and per-rank bytes
# ---------------------------------------------------------------------------
def local_shape(mesh, spec: P, shape) -> Tuple[int, ...]:
    """The local shape ``spec`` gives a leaf of ``shape``; raises where a
    split dimension does not divide."""
    out = list(shape)
    for d, axes in split_dims(mesh, spec):
        n = mesh.size(axes)
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def tree_local_bytes(mesh, tree, specs, dtype_of=lambda t: t.dtype) -> int:
    """Bytes of the leaves of ``tree`` at their local shapes under
    ``specs`` (flatten order), each in ``dtype_of(leaf)``."""
    return sum(_nbytes(local_shape(mesh, spec, tuple(t.shape)), dtype_of(t))
               for t, spec in zip(leaves(tree), specs))


def _bf16_params(t: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if t.dtype == torch.float32 else t.dtype


def rank_bytes(cfg: ModelConfig, shape: str, mesh) -> Dict[str, int]:
    """Coherence and one rank's bytes (every rank's, under even splits):
    parameters at bf16, AdamW moments at float32 and the step counters
    (train), the batch, the cache (prefill and decode); and the float32
    train state the port's training holds."""
    kind = SHAPES[shape]["kind"]
    tmpl = train_mod.param_template(cfg)
    train_mod.split_table(mesh, tmpl)                 # raises on a conflict
    specs = train_mod.tree_specs(mesh, tmpl)
    out = {"params": tree_local_bytes(mesh, tmpl, specs, _bf16_params),
           "opt": 0, "batch": 0, "cache": 0}
    if kind == "train":
        state = train_mod.state_template(cfg)
        st_specs = train_mod.tree_specs(mesh, state)
        total32 = tree_local_bytes(mesh, state, st_specs)
        out["opt"] = total32 - tree_local_bytes(mesh, tmpl, specs)
        out["state_f32"] = total32
    ins = input_specs(cfg, shape)
    bspecs = train_mod.batch_shardings(mesh, ins)
    out["batch"] = sum(_nbytes(local_shape(mesh, bspecs[k], tuple(v.shape)),
                               v.dtype) for k, v in ins.items())
    if kind != "train":
        info = SHAPES[shape]
        seq_shard = kind == "decode" and info["global_batch"] == 1
        cache = cache_specs(cfg, shape)
        cspecs = cache_shardings(mesh, cfg, cache, seq_shard)
        out["cache"] = sum(_nbytes(local_shape(mesh, cspecs[k],
                                               tuple(v.shape)), v.dtype)
                           for k, v in cache.items())
    out["total"] = out["params"] + out["opt"] + out["batch"] + out["cache"]
    return out


# ---------------------------------------------------------------------------
# one rank's step on meta tensors
# ---------------------------------------------------------------------------
def _batch_block(mesh, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch, where the data axes divide
    it."""
    specs = train_mod.batch_shardings(mesh, batch)
    out = {}
    for k, v in batch.items():
        for d, axes in split_dims(mesh, specs[k]):
            v = coll.local_block(v, mesh, axes, d)
        out[k] = v
    return out


def run_step(cfg: ModelConfig, shape: str, mesh) -> Tuple[str, Any]:
    """Trace one rank's step of the cell on meta tensors; returns the
    route and the step's output. Call under ``FlopCounterMode`` and
    :func:`recording_collectives`."""
    info = SHAPES[shape]
    kind = info["kind"]
    ins = input_specs(cfg, shape)
    if kind == "train":
        state = train_mod.shard_state(train_mod.state_template(cfg), mesh)
        step = train_mod.make_train_step(cfg, AdamWConfig(), mesh=mesh)
        return "sharded", step(state, ins)
    params = train_mod.param_template(cfg)
    local = _batch_block(mesh, ins)
    if kind == "prefill":
        max_len = info["seq_len"] // 2 if cfg.encoder_layers \
            else info["seq_len"]
        return "data-parallel", prefill(params, cfg, local, max_len=max_len)
    b = local["token"].shape[0]
    cache = cache_specs(cfg, shape, batch=b)
    dec_len, _ = _cache_lengths(cfg, shape)
    return "data-parallel", decode_step(params, cfg, cache, local["token"],
                                        dec_len - 1)


def count_step(cfg: ModelConfig, shape: str, mesh
               ) -> Tuple[float, Dict[str, float], str]:
    """(FLOPs, collective output bytes by kind, route) of one rank's
    step."""
    with recording_collectives() as log, \
            FlopCounterMode(display=False) as counter:
        route, _ = run_step(cfg, shape, mesh)
    return float(counter.get_total_flops()), dict(log), route


def _run_config(cfg: ModelConfig, shape: str) -> ModelConfig:
    """The reference's per-cell settings: remat in train cells, the
    chunked SSD scan."""
    return dataclasses.replace(cfg, remat=(SHAPES[shape]["kind"] == "train"),
                               ssd_backend="chunked")


# ---------------------------------------------------------------------------
# the dry run itself
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape: str, mesh_kind: str, save: bool = True,
             verbose: bool = True,
             cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One cell: coherence, per-rank bytes, FLOPs and collective bytes of
    one rank's step, roofline terms. ``cfg`` replaces ``arch``'s config
    (a reduced one, say; ``arch`` still names the cell). Never raises for
    the cell's own failure: its status is ``"FAILED"`` with the error."""
    cfg = get_config(arch) if cfg is None else cfg
    ok, reason = cell_is_applicable(cfg, shape)
    mesh = make_dry_mesh(mesh_kind)
    chips = mesh.ranks
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": chips,
        "status": "skipped" if not ok else "pending", "reason": reason,
    }
    if not ok:
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_kind}: SKIP ({reason})")
        if save:
            _save(result)
        return result
    t0 = time.time()
    try:
        run_cfg = _run_config(cfg, shape)
        nbytes = rank_bytes(run_cfg, shape, mesh)
        flops, coll_detail, route = count_step(run_cfg, shape, mesh)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        result["status"] = "FAILED"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_kind}: FAILED "
                  f"{result['error'][:300]}")
        if save:
            _save(result)
        return result
    coll_total = sum(coll_detail.values())
    mflops = model_flops(cfg, shape)
    result.update({
        "status": "ok",
        "trace_s": time.time() - t0,
        "flops": flops,                        # per rank
        "flops_route": route,
        "collective_bytes": coll_detail,
        "collective_total": coll_total,
        "bytes_per_rank": nbytes,
        # per-rank numerators, so one rank's rates in the denominators
        "roofline": roofline_terms(flops, nbytes["total"], coll_total, 1),
        "model_flops": mflops,
        "model_flops_per_chip": mflops / chips,
        "useful_flops_frac": (mflops / chips) / flops if flops else 0.0,
    })
    if cfg.is_moe:
        result["assumed"] = MOE_ASSUMPTION
    result["dominant_term"] = max(result["roofline"],
                                  key=result["roofline"].get)
    if verbose:
        r = result["roofline"]
        print(f"[dryrun] {arch} x {shape} x {mesh_kind}: OK "
              f"trace={result['trace_s']:.1f}s "
              f"bytes/rank={nbytes['total'] / 2**30:.2f}GiB "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"coll={r['collective_s']*1e3:.2f}ms "
              f"dom={result['dominant_term']} "
              f"useful={result['useful_flops_frac']:.2f} ({route})")
    if save:
        _save(result)
    return result


def _save(result: Dict[str, Any]) -> None:
    os.makedirs(RESULT_DIR, exist_ok=True)
    mesh = result["mesh"].replace(",", "x")
    name = f"{result['arch']}__{result['shape']}__{mesh}.json"
    with open(os.path.join(RESULT_DIR, name), "w") as f:
        json.dump(result, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    help="pod (16x16), multipod (2x16x16), both, or DP,TP")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs.archs import ARCH_IDS
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                r = run_cell(arch, shape, mesh_kind)
                failures += r["status"] == "FAILED"
    print(f"[dryrun] done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
