"""LM serving (counterpart of ``repro/launch/serve.py``): static batched
prefill + decode, or continuous batching through
:mod:`repro_torch.serving`, with optional OPIMA-PIM weight execution.

Two serving modes:

  * static (default): one batch, lock-step decode — every request shares
    a prompt length and finishes together.
  * ``--continuous``: synthetic Poisson (or trace-driven) arrivals with
    heterogeneous prompt/generation lengths stream through the
    continuous-batching scheduler — a fixed pool of decode slots over
    the same programmed plans, prefill interleaved with in-flight decode,
    retired slots refilled immediately.

With ``--pim``, the attention (q/k/v/o), MLP and shared-expert
(up/gate/down) projections of every layer are *programmed once* into
planned 'OPCM' form through :mod:`repro_torch.engine` (4-bit cells by
default, nibble-decomposed and pre-padded), one ``DensePlan`` per layer,
and every MoE expert stack into one ``ExpertStackedPlan`` per layer; the
weights are programmed layer by layer as they are drawn. The
serving matmuls drive activations past them on the substrate named by
``--pim-substrate`` (default ``exact-cuda``, the hand-written kernel; the
JAX names are accepted). Weights the engine does not cover (SSM
projections, embedding tables) are fake-quantized instead, so every
substrate still models their cell-density quantization. ``--plan-dir
DIR`` persists the programmed tree (:func:`repro_torch.engine.save_plans`)
so that a restart restores it instead of programming again. An OPIMA
hardware latency/energy estimate is reported next to the wall-clock
numbers; ``--metrics-json PATH`` writes the structured result.

Not ported yet, and raising: ``--mesh`` (ROADMAP A11), ``--abft``,
``--inject-faults`` and ``--chaos-check`` (A9), ``--sanitize`` (A13), and
the compile cache (the port has no compiled step functions; ROADMAP path
glue item 2 would capture decode in a CUDA graph).

Run (full width, on the card; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --batch 8 --prompt-len 512 --gen 16 --pim
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --pim --plan-dir /path/to/plans --continuous --num-slots 8 \
      --requests 32 --prompt-len 512 --gen 16 --sync-every 4
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import engine
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import pim as pim_mod
from repro_torch.core.perfmodel import network_perf, total_power_w
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import DenseSpec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.lm import (decode_step, init_lm, layer_trees,
                                   prefill, stack_layers)
from repro_torch.quant.quantize import fake_quantize

# Weight suffixes the PIM deployment touches (layers.py naming
# conventions), for both the plan path and the fake-quantize path.
PIM_WEIGHT_SUFFIXES = ("_dh", "_hd", "_vd", "_dn", "_edf", "_efd")
# Of those, the ones programmed onto the engine: 2-D projections stacked
# over layers, and expert-stacked MoE tensors.
_PLANNED_PROJ_SUFFIXES = ("_dh", "_hd")
_EXPERT_STACK_SUFFIXES = ("_edf", "_efd")
# Blocks whose weights are planned (nested dicts are walked).
_PLANNED_BLOCKS = ("attn", "xattn", "mlp", "moe")


def _will_plan(keys: Sequence[str], name: str, x) -> bool:
    """Whether a leaf of one layer's tree (no layer axis) is programmed:
    the (K, N) projections and (E, K, N) expert stacks of the planned
    blocks."""
    if not any(k in _PLANNED_BLOCKS for k in keys):
        return False
    ndim = x.dim() if torch.is_tensor(x) else 0
    return ((name.endswith(_PLANNED_PROJ_SUFFIXES) and ndim == 2) or
            (name.endswith(_EXPERT_STACK_SUFFIXES) and ndim == 3))


def _quantizable(name: str, x) -> bool:
    return (torch.is_tensor(x) and x.dim() >= 2 and
            name.endswith(PIM_WEIGHT_SUFFIXES))


def _quantize_leaf(name: str, v, cfg: PimConfig):
    """A leaf fake-quantized per output column if it is quantizable; a
    dict with every quantizable leaf so."""
    if isinstance(v, dict):
        return {k: _quantize_leaf(k, x, cfg) for k, x in v.items()}
    if _quantizable(name, v):
        return fake_quantize(v, cfg.weight_bits, axis=(v.dim() - 2,))
    return v


def plan_layer(layer, cfg: PimConfig):
    """One layer's parameters (no layer axis) in planned 'OPCM' form: each
    (K, N) projection of the attention, MLP and shared-expert blocks
    becomes a :class:`~repro_torch.core.pim.DensePlan`, each (E, K, N)
    MoE expert stack an :class:`~repro_torch.core.pim.ExpertStackedPlan`,
    programmed from the float weights on the substrate ``cfg`` names.
    Every other ``PIM_WEIGHT_SUFFIXES`` leaf of two or more dimensions
    (SSM projections) is fake-quantized per output column; the router
    stays float. The JAX package's predicates."""
    sub = engine.get_substrate(cfg.resolved_substrate)

    def walk(tree, keys):
        out = {}
        for k, v in tree.items():
            path = keys + [k]
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif _will_plan(path, k, v):
                out[k] = (sub.program_experts(v, cfg) if v.dim() == 3
                          else sub.program(v, cfg))
            else:
                out[k] = _quantize_leaf(k, v, cfg)
        return out

    return walk(layer, [])


def plan_params_for_pim(params, cfg: PimConfig):
    """Program the deployable weights into planned 'OPCM' form.

    Each layer of the stacked layer tree goes through :func:`plan_layer`,
    so every (L, K, N) projection becomes a list of L plans and every
    (L, E, K, N) expert stack a list of L expert-stacked plans
    (``lm.layer_trees`` takes the lists' entries per layer,
    ``layers.proj`` and ``moe.moe_apply`` dispatch them onto the engine).
    Quantize + nibble-decompose + kernel pre-pad happen here, once. The
    embedding tables are fake-quantized per output column. Serving's
    set-up does the same one layer at a time as the weights are drawn
    (``lm.init_lm(..., layer_fn=)``), bit for bit."""
    def plan_layers(layers):
        n = layers
        while isinstance(n, dict):        # the leading axis of any leaf
            n = next(iter(n.values()))
        return stack_layers([plan_layer(lp, cfg)
                             for lp in layer_trees(layers, len(n))])

    return {k: plan_layers(v) if k in ("layers", "enc_layers")
            else _quantize_leaf(k, v, cfg) for k, v in params.items()}


def opima_lm_estimate(cfg: ModelConfig, batch: int, prompt: int, gen: int,
                      pim: PimConfig) -> Dict[str, float]:
    """Map the request batch's GEMMs onto the OPIMA perf model (weight-
    stationary FC mapping, §IV.D) for a hardware-side estimate."""
    specs = []
    heads_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    tokens = batch * (prompt + gen)
    for li in range(cfg.num_layers):
        if cfg.block_type in ("attn", "hybrid"):
            specs += [DenseSpec(f"l{li}.q", cfg.d_model, heads_dim),
                      DenseSpec(f"l{li}.k", cfg.d_model, kv_dim),
                      DenseSpec(f"l{li}.v", cfg.d_model, kv_dim),
                      DenseSpec(f"l{li}.o", heads_dim, cfg.d_model)]
        if cfg.is_moe:
            # the routed drive: only the k selected experts' stationary
            # arrays are driven per token
            ff = cfg.moe_d_ff * cfg.experts_per_token
            specs += [DenseSpec(f"l{li}.moe_up", cfg.d_model, 2 * ff),
                      DenseSpec(f"l{li}.moe_dn", ff, cfg.d_model)]
        elif cfg.d_ff:
            mult = 2 if cfg.gated_mlp else 1
            specs += [DenseSpec(f"l{li}.up", cfg.d_model, mult * cfg.d_ff),
                      DenseSpec(f"l{li}.dn", cfg.d_ff, cfg.d_model)]
    if not specs:
        # pure-SSM architectures map no GEMMs onto the PIM arrays
        return {
            "opima_latency_ms_per_token_batch": 0.0,
            "opima_energy_mj_per_token_batch": 0.0,
            "opima_request_s": 0.0,
            "opima_tokens_per_s": 0.0,
            "opima_power_w": total_power_w(),
        }
    perf = network_perf(cfg.name, specs, weight_bits=pim.weight_bits,
                        act_bits=pim.act_bits)
    # one weight-stationary pass of the network per sequential token step
    steps = prompt + gen
    total_s = perf.latency_s * steps
    return {
        "opima_latency_ms_per_token_batch": perf.latency_s * 1e3,
        "opima_energy_mj_per_token_batch": perf.energy_j * 1e3,
        "opima_request_s": total_s,
        "opima_tokens_per_s": tokens / total_s,
        "opima_power_w": total_power_w(),
    }


def _resolve_substrate(pim_substrate: Optional[str],
                       pim_emulate: bool) -> str:
    if pim_emulate:
        warnings.warn("pim_emulate is deprecated; use "
                      "pim_substrate='emulate'", DeprecationWarning,
                      stacklevel=4)
        if pim_substrate not in (None, "emulate"):
            raise ValueError(
                "--pim-emulate (deprecated) conflicts with an explicit "
                f"--pim-substrate {pim_substrate!r}; drop --pim-emulate "
                "and pass --pim-substrate emulate instead")
        return pim_mod.EMULATE
    return pim_mod.SUBSTRATE_ALIASES.get(pim_substrate, pim_substrate) \
        if pim_substrate else pim_mod.EXACT_CUDA


def _not_ported(mesh_spec, compile_cache_dir) -> None:
    if mesh_spec:
        raise NotImplementedError(
            "mesh: sharded serving is not ported yet (ROADMAP A11)")
    if compile_cache_dir:
        raise NotImplementedError(
            "compile_cache_dir: the port runs its step functions eagerly "
            "and has nothing to cache; a captured decode step would be its "
            "first (ROADMAP path glue item 2, CUDA-graph decode)")


def _program(cfg: ModelConfig, pim_cfg: PimConfig, device):
    """Draw the weights (seed 0) and program each layer as soon as it is
    drawn (equal to ``plan_params_for_pim`` of ``init_lm``'s params, bit
    for bit); the embedding tables are fake-quantized."""
    # a MoE model's float32 expert stacks need not fit the card at once
    params = init_lm(cfg, 0, device=device,
                     layer_fn=lambda layer: plan_layer(layer, pim_cfg))
    return {k: v if k == "layers" else _quantize_leaf(k, v, pim_cfg)
            for k, v in params.items()}


def _dict_leaves(tree, keys=()):
    """(key tuple, tensor) of a nested dict of tensors, in any order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dict_leaves(v, keys + (k,))
        else:
            yield keys + (k,), v


def _params_digest(cfg: ModelConfig, device) -> str:
    """Content hash of the float weights ``_program`` draws (seed 0):
    restored plans must have been programmed from these exact weights,
    not merely a tree of the same arch and geometry.

    The JAX package hashes every leaf's bytes, in leaf order, with one
    sha256, which needs all float layers at once. Here the weights are
    drawn layer by layer as ``_program`` draws them: each leaf has its own
    sha256, fed its layers in order (the bytes of the stacked leaf) on a
    thread of its own while the next layer is drawn, and the digest is the
    sha256 of those per-leaf digests in JAX's leaf order. So the port's
    digest is not JAX's (nor are its seed-0 weights: a JAX serve directory
    re-programs here)."""
    hashers, queues, updates = {}, {}, []

    def feed(key, t):
        arr = np.ascontiguousarray(t.detach().cpu().numpy())
        if key not in hashers:
            hashers[key] = hashlib.sha256()
            # one worker per leaf keeps each leaf's layers in order
            queues[key] = ThreadPoolExecutor(max_workers=1)
        updates.append(queues[key].submit(hashers[key].update,
                                          arr.reshape(-1).view(np.uint8)))

    def hash_layer(layer):
        for key, t in _dict_leaves(layer, ("layers",)):
            feed(key, t)
        return {}

    try:
        params = init_lm(cfg, 0, device=device, layer_fn=hash_layer)
        for key, t in _dict_leaves(params):
            feed(key, t)
        del params
    finally:
        for pool in queues.values():
            pool.shutdown(wait=True)
    for update in updates:
        update.result()
    # sorted key tuples are JAX's flatten order (dict keys sorted, depth
    # first)
    return hashlib.sha256("".join(
        hashers[k].hexdigest() for k in sorted(hashers)).encode()
    ).hexdigest()[:16]


def _same_extras(got: Dict[str, Any], want: Dict[str, Any]) -> bool:
    """Extras equal, the substrate compared after alias resolution."""
    resolve = lambda d: dict(d, substrate=pim_mod.SUBSTRATE_ALIASES.get(
        d.get("substrate"), d.get("substrate")))
    return resolve(got) == resolve(want)


def _pim_params(cfg: ModelConfig, pim_cfg: PimConfig,
                plan_dir: Optional[str], device):
    """Program (or restore) the PIM parameter tree.

    With ``plan_dir`` set, the weights are first drawn for their digest;
    then a previously saved plan checkpoint is restored (serving restarts
    skip re-programming) or, on any mismatch of model identity, geometry
    or operating point (arch, reduced dims, substrate, bit widths, the
    weights' digest), or any restore failure, the plans are programmed
    afresh and persisted for the next boot. A save that fails on
    ``OSError`` serves without a checkpoint."""
    if not plan_dir:
        return _program(cfg, pim_cfg, device)
    want = {"substrate": pim_cfg.resolved_substrate,
            "weight_bits": pim_cfg.weight_bits,
            "act_bits": pim_cfg.act_bits,
            "abft": pim_cfg.verify,
            "arch": cfg.name,
            "num_layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "vocab_size": cfg.vocab_size,
            "mesh": None,
            "params_digest": _params_digest(cfg, device)}
    try:
        planned, _, extras = engine.load_plans(plan_dir, device=device)
    except FileNotFoundError:
        pass
    except Exception as e:  # noqa: BLE001: any restore failure re-programs
        print(f"[serve] could not restore plans from {plan_dir} "
              f"({type(e).__name__}: {e}); re-programming")
    else:
        got = {k: extras.get(k) for k in want}
        if _same_extras(got, want):
            print(f"[serve] restored programmed plans from {plan_dir} "
                  f"(substrate={got['substrate']})")
            return planned
        del planned
        print(f"[serve] plan checkpoint at {plan_dir} was programmed "
              f"for {got}, requested {want}; re-programming")
    planned = _program(cfg, pim_cfg, device)
    try:
        engine.save_plans(plan_dir, planned, extras=want)
        print(f"[serve] saved programmed plans to {plan_dir}")
    except OSError as e:
        print(f"[serve] could not save plans to {plan_dir} "
              f"({type(e).__name__}: {e}); serving without a checkpoint")
    return planned


def _setup(arch: str, layers: Optional[int], d_model: Optional[int],
           pim: bool, pim_bits: int, pim_emulate: bool,
           pim_substrate: Optional[str], plan_dir: Optional[str],
           mesh_spec: Optional[str] = None,
           compile_cache_dir: Optional[str] = None, abft: str = "off",
           device=None):
    """Serve bring-up: config reduction, parameter init (random, seed 0)
    and, with ``pim``, weight programming, layer by layer as the weights
    are drawn, or its restore from ``plan_dir``. Returns
    ``(cfg, params, substrate, pim_cfg, mesh)``; ``mesh`` is always None
    in the port."""
    _not_ported(mesh_spec, compile_cache_dir)
    device = resolve_device(device)
    cfg = get_config(arch)
    if layers or d_model:
        cfg = cfg.reduced(num_layers=layers or 2, d_model=d_model or 64,
                          vocab=min(cfg.vocab_size, 512))
    substrate = _resolve_substrate(pim_substrate, pim_emulate)
    pim_cfg = PimConfig(weight_bits=pim_bits, act_bits=pim_bits,
                        substrate=substrate, verify=abft)
    if not pim:
        return cfg, init_lm(cfg, 0, device=device), substrate, pim_cfg, None
    return (cfg, _pim_params(cfg, pim_cfg, plan_dir, device), substrate,
            pim_cfg, None)


def write_metrics_json(path: str, result: Dict[str, Any]) -> None:
    """Dump a serve result as structured JSON (arrays -> lists)."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.tolist()
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v
    with open(path, "w") as f:
        json.dump(conv(result), f, indent=2, sort_keys=True)
        f.write("\n")


class _Clock:
    """Marks on the device's timeline: CUDA events on a card, the host
    clock on the CPU (where the work is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, start, end) -> float:
        if not self.cuda:
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def static_loop(params, cfg: ModelConfig, tokens: torch.Tensor, gen: int,
                max_len: Optional[int] = None):
    """The static serving loop: prefill the (B, S) prompt batch, then
    ``gen`` greedy lock-step decode steps. Tokens stay on the device
    until the loop ends. Returns ``(generated (B, gen) tensor on the
    device, prefill seconds, decode seconds, prefill logits)``; on a card
    the times come from CUDA events around each phase."""
    prompt_len = tokens.shape[1]
    max_len = prompt_len + gen if max_len is None else max_len
    clock = _Clock(tokens.device)
    t0 = clock.mark()
    logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len)
    t1 = clock.mark()
    first = logits
    out_tokens = []
    tok = torch.argmax(logits, -1)[:, None]
    for g in range(gen):
        out_tokens.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok, prompt_len + g)
        tok = torch.argmax(logits, -1)[:, None]
    t2 = clock.mark()
    generated = torch.cat(out_tokens, dim=1) if out_tokens else \
        tokens.new_zeros((tokens.shape[0], 0))
    return generated, clock.seconds(t0, t1), clock.seconds(t1, t2), first


def serve(arch: str, batch: int = 2, prompt_len: int = 16, gen: int = 8,
          layers: Optional[int] = None, d_model: Optional[int] = None,
          pim: bool = False, pim_bits: int = 4, pim_emulate: bool = False,
          greedy: bool = True, pim_substrate: Optional[str] = None,
          plan_dir: Optional[str] = None, mesh: Optional[str] = None,
          compile_cache_dir: Optional[str] = None,
          metrics_json: Optional[str] = None,
          stop_tokens: Sequence[int] = (),
          eos_token: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Run one batched serve request on ``device`` (``None``: CUDA);
    ``pim_substrate`` names the engine route (default ``exact-cuda``).

    ``stop_tokens`` / ``eos_token`` are applied *post hoc*: the lock-step
    loop runs all ``gen`` steps, then each row is truncated at its first
    stop token and classified."""
    cfg, params, substrate, pim_cfg, _ = _setup(
        arch, layers, d_model, pim, pim_bits, pim_emulate, pim_substrate,
        plan_dir, mesh_spec=mesh, compile_cache_dir=compile_cache_dir,
        device=device)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(dev)
    generated, t_prefill, t_decode, _ = static_loop(params, cfg, tokens, gen)
    total_s = t_prefill + t_decode
    generated = generated.cpu().numpy()

    stop_set = {int(t) for t in stop_tokens}
    if eos_token is not None:
        stop_set.add(int(eos_token))
    is_stop = np.isin(generated, sorted(stop_set))
    reasons: List[str] = []
    emitted: List[List[int]] = []
    for row, row_stop in zip(generated.tolist(), is_stop):
        reason, cut = "budget", len(row)
        hits = np.flatnonzero(row_stop)
        if hits.size:
            cut = int(hits[0]) + 1
            reason = ("eos" if eos_token is not None
                      and row[cut - 1] == int(eos_token) else "stop_token")
        reasons.append(reason)
        emitted.append(row[:cut])
    reason_counts = {"budget": 0, "eos": 0, "stop_token": 0}
    for r in reasons:
        reason_counts[r] += 1
    result = {
        "mode": "static",
        "arch": cfg.name,
        "generated": generated,
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / gen,
        "generated_tokens": batch * gen,
        "tokens_per_s": batch * gen / total_s if total_s > 0 else 0.0,
        "stop_reasons": reason_counts,
        "row_stop_reasons": reasons,
        "emitted": emitted,
        "emitted_tokens": sum(len(e) for e in emitted),
    }
    if pim:
        result["pim_substrate"] = substrate
        result.update(opima_lm_estimate(cfg, batch, prompt_len, gen,
                                        pim_cfg))
    if metrics_json:
        write_metrics_json(metrics_json, result)
    return result


def _load_trace(trace_file: str, vocab: int, seed: int) -> List[Any]:
    """Trace-driven arrivals: a JSON list of request records, each with
    ``arrival`` (float steps) and either explicit ``tokens`` or a
    ``prompt_len`` (tokens drawn deterministically from ``seed``), plus
    ``gen`` (max new tokens)."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    with open(trace_file) as f:
        records = json.load(f)
    reqs = []
    for i, rec in enumerate(records):
        if "gen" not in rec:
            raise ValueError(
                f"trace record {i} in {trace_file} is missing 'gen' "
                f"(max new tokens): {rec}")
        if "tokens" in rec:
            toks = np.asarray(rec["tokens"], np.int32)
        elif "prompt_len" in rec:
            toks = rng.integers(0, vocab,
                                size=(int(rec["prompt_len"]),)).astype(
                                    np.int32)
        else:
            raise ValueError(
                f"trace record {i} in {trace_file} needs either "
                f"'tokens' or 'prompt_len': {rec}")
        deadline = rec.get("deadline")
        reqs.append(Request(
            request_id=rec.get("id", i), tokens=toks,
            max_new_tokens=int(rec["gen"]),
            arrival=float(rec.get("arrival", 0.0)),
            shared_prefix_len=int(rec.get("shared_prefix_len", 0)),
            deadline=float(deadline) if deadline is not None else None))
    return reqs


def _not_ported_continuous(sanitize: bool, abft: str,
                           inject_faults: Optional[str],
                           chaos_check: bool) -> None:
    if abft != "off" or inject_faults or chaos_check:
        raise NotImplementedError(
            "--abft / --inject-faults / --chaos-check: ABFT-verified "
            "serving, fault injection and the degradation machine are not "
            "ported yet (ROADMAP A9)")
    if sanitize:
        raise NotImplementedError(
            "--sanitize: the runtime sanitizers are not ported yet "
            "(ROADMAP A13)")


def serve_continuous(arch: str, num_slots: int = 4, num_requests: int = 16,
                     prompt_len: int = 16, gen: int = 8,
                     layers: Optional[int] = None,
                     d_model: Optional[int] = None, pim: bool = False,
                     pim_bits: int = 4, pim_emulate: bool = False,
                     pim_substrate: Optional[str] = None,
                     plan_dir: Optional[str] = None,
                     arrival_rate: float = 0.5,
                     trace_file: Optional[str] = None, seed: int = 0,
                     sync_every: int = 1, mesh: Optional[str] = None,
                     compile_cache_dir: Optional[str] = None,
                     metrics_json: Optional[str] = None,
                     sanitize: bool = False,
                     stop_tokens: Sequence[int] = (),
                     eos_token: Optional[int] = None,
                     prefill_chunk: Optional[int] = None,
                     prefix_cache: int = 0,
                     shared_prefix: int = 0,
                     abft: str = "off",
                     inject_faults: Optional[str] = None,
                     admission_policy: str = "fifo",
                     chaos_check: bool = False,
                     device=None) -> Dict[str, Any]:
    """Continuous-batching serve on ``device`` (``None``: CUDA): requests
    with heterogeneous arrival times and prompt/generation lengths stream
    through a fixed pool of ``num_slots`` decode slots backed by the same
    programmed plans the static path uses.

    Without ``trace_file``, a synthetic Poisson trace is generated:
    exponential inter-arrivals at ``arrival_rate`` requests/step, prompt
    lengths mixed in [prompt_len//4, prompt_len], generation lengths in
    [max(1, gen//4), gen]. ``prompt_len``/``gen`` therefore bound the
    slot geometry: prompts pad to ``prompt_len`` (plus the shared
    prefix, when one is configured), the KV cache rows are
    ``prompt_pad + gen`` long.

    Serving-engine semantics pass straight through: ``stop_tokens`` /
    ``eos_token`` retire a slot the step its sequence finishes
    (on-device detection), ``prefill_chunk`` interleaves long prompts
    with decode one chunk per scheduler iteration, ``prefix_cache``
    (entry capacity) turns on content-hashed KV reuse, and
    ``shared_prefix`` prepends a common random prefix of that length to
    every synthetic prompt. ``abft``, ``inject_faults``, ``chaos_check``
    (ROADMAP A9), ``sanitize`` (A13) and ``mesh`` (A11) raise."""
    from repro_torch.serving import ContinuousScheduler, poisson_trace
    if shared_prefix < 0:
        raise ValueError("shared_prefix must be >= 0")
    _not_ported_continuous(sanitize, abft, inject_faults, chaos_check)
    cfg, params, substrate, pim_cfg, _ = _setup(
        arch, layers, d_model, pim, pim_bits, pim_emulate, pim_substrate,
        plan_dir, mesh_spec=mesh, compile_cache_dir=compile_cache_dir,
        device=device)
    if trace_file:
        requests = _load_trace(trace_file, cfg.vocab_size, seed)
        if not requests:
            raise ValueError(f"trace file {trace_file} contains no "
                             "requests")
        prompt_pad = max(int(np.asarray(r.tokens).shape[0])
                         for r in requests)
        max_len = prompt_pad + max(r.max_new_tokens for r in requests)
    else:
        p_lo = max(1, prompt_len // 4)
        g_lo = max(1, gen // 4)
        requests = poisson_trace(
            n=num_requests, rate=arrival_rate,
            prompt_lens=list(range(p_lo, prompt_len + 1)),
            gen_lens=list(range(g_lo, gen + 1)),
            vocab=cfg.vocab_size, seed=seed,
            shared_prefix_len=shared_prefix)
        prompt_pad = prompt_len + shared_prefix
        max_len = prompt_pad + gen
    sched = ContinuousScheduler(params, cfg, num_slots=num_slots,
                                prompt_pad=prompt_pad, max_len=max_len,
                                sync_every=sync_every,
                                stop_tokens=stop_tokens,
                                eos_token=eos_token,
                                prefill_chunk=prefill_chunk,
                                prefix_cache=prefix_cache,
                                admission_policy=admission_policy)
    sched.warmup()   # keep first-call costs out of the metered run
    run = sched.run(requests)

    result: Dict[str, Any] = dict(run.metrics)
    result["arch"] = cfg.name
    result["requests"] = [
        {"id": c.request_id, "prompt_len": int(c.prompt.shape[0]),
         "tokens": c.tokens, "arrival_step": c.arrival_step,
         "ttft_steps": c.ttft_steps, "latency_steps": c.latency_steps,
         "stop_reason": c.stop_reason,
         "first_token_wall_s": c.first_token_wall_s}
        for c in run.completions]
    if pim:
        result["pim_substrate"] = substrate
        # OPIMA hardware-side estimate for the aggregate workload: one
        # weight-stationary pass of the network per sequential token
        # position (true prompt lengths) plus one per decode step; the
        # slot batch's rows stream through the arrays within a pass.
        est = opima_lm_estimate(cfg, batch=1, prompt=0, gen=1, pim=pim_cfg)
        pass_s = est["opima_latency_ms_per_token_batch"] / 1e3
        total_passes = run.metrics["decode_steps"] + sum(
            int(c.prompt.shape[0]) for c in run.completions)
        if pass_s > 0:
            result["opima_latency_ms_per_token_batch"] = pass_s * 1e3
            result["opima_request_s"] = pass_s * total_passes
            result["opima_tokens_per_s"] = (
                run.metrics["generated_tokens"] / (pass_s * total_passes))
            result["opima_power_w"] = est["opima_power_w"]
    if metrics_json:
        write_metrics_json(metrics_json, result)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--pim", action="store_true")
    ap.add_argument("--pim-bits", type=int, default=4)
    ap.add_argument("--pim-substrate", default=None,
                    choices=engine.available_substrates()
                    + tuple(pim_mod.SUBSTRATE_ALIASES),
                    help="engine substrate the programmed plans execute on "
                         "(default: exact-cuda)")
    ap.add_argument("--pim-emulate", action="store_true",
                    help="deprecated alias for --pim-substrate emulate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--plan-dir", default=None,
                    help="persist/restore programmed plans here so "
                         "restarts skip re-programming")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="not ported yet (ROADMAP A11)")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="not ported: the port has no compiled step "
                         "functions (ROADMAP path glue item 2)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: Poisson/trace arrivals "
                         "through the slot scheduler (repro_torch/serving)")
    ap.add_argument("--num-slots", type=int, default=4,
                    help="decode-slot pool size (continuous mode)")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic request count (continuous mode)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="Poisson arrivals per decode step; <= 0 means "
                         "one burst at t=0 (continuous mode)")
    ap.add_argument("--trace-file", default=None,
                    help="JSON arrival trace instead of synthetic "
                         "Poisson traffic (continuous mode)")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="fused decode steps per host sync (continuous "
                         "mode); tokens are identical to 1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-tokens", default=None, metavar="T1,T2,...",
                    help="comma-separated stop-token ids (continuous mode: "
                         "detected on the device, slot retired at once; "
                         "static mode: rows truncated post hoc)")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="EOS token id (reported as stop_reason='eos')")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill (continuous mode): prompts in "
                         "chunks of this many tokens, one per scheduler "
                         "iteration; tokens are bit-identical to "
                         "single-shot prefill")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="CAP",
                    help="content-hashed prefix-cache capacity in entries "
                         "(continuous mode): 0 disables")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="LEN",
                    help="prepend a common random prefix of LEN tokens "
                         "to every synthetic prompt (continuous mode)")
    ap.add_argument("--admission-policy", default="fifo",
                    choices=("fifo", "sjf"),
                    help="admission order (continuous mode)")
    ap.add_argument("--abft", default="off",
                    choices=("off", "sample", "always"),
                    help="not ported yet (ROADMAP A9)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC.json",
                    help="not ported yet (ROADMAP A9)")
    ap.add_argument("--chaos-check", action="store_true",
                    help="not ported yet (ROADMAP A9)")
    ap.add_argument("--sanitize", action="store_true",
                    help="not ported yet (ROADMAP A13)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the structured run metrics to this path")
    args = ap.parse_args()
    _not_ported_continuous(args.sanitize, args.abft, args.inject_faults,
                           args.chaos_check)
    stop_tokens = tuple(
        int(t) for t in args.stop_tokens.split(",") if t.strip()
    ) if args.stop_tokens else ()
    if args.continuous:
        res = serve_continuous(
            args.arch, num_slots=args.num_slots,
            num_requests=args.requests, prompt_len=args.prompt_len,
            gen=args.gen, layers=args.layers, d_model=args.d_model,
            pim=args.pim, pim_bits=args.pim_bits,
            pim_emulate=args.pim_emulate,
            pim_substrate=args.pim_substrate, plan_dir=args.plan_dir,
            arrival_rate=args.arrival_rate, trace_file=args.trace_file,
            seed=args.seed, sync_every=args.sync_every, mesh=args.mesh,
            compile_cache_dir=args.compile_cache_dir,
            metrics_json=args.metrics_json, stop_tokens=stop_tokens,
            eos_token=args.eos_token, prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache,
            shared_prefix=args.shared_prefix,
            admission_policy=args.admission_policy, device=args.device)
        print(f"[serve] continuous: {res['num_requests']} requests through "
              f"{res['num_slots']} slots, {res['decode_steps']} decode "
              f"steps in {res['host_syncs']} host syncs "
              f"(sync_every={res['sync_every']}), {res['prefills']} "
              f"prefills (step shapes: {res['prefill_traces']}/"
              f"{res['decode_traces']})")
        print(f"[serve] {res['generated_tokens']} tokens, "
              f"{res['tokens_per_s']:.1f} tok/s wall, "
              f"occupancy {res['mean_slot_occupancy']:.2f}")
        print(f"[serve] ttft p50/p90/p99 = {res['ttft_steps_p50']:.1f}/"
              f"{res['ttft_steps_p90']:.1f}/{res['ttft_steps_p99']:.1f} "
              f"steps; latency p50/p90/p99 = {res['latency_steps_p50']:.1f}/"
              f"{res['latency_steps_p90']:.1f}/"
              f"{res['latency_steps_p99']:.1f} steps")
        print(f"[serve] stop reasons: {res['stop_reasons']}" + (
            f"; prefix cache: {res['prefix_cache']}"
            if res.get("prefix_cache") else ""))
    else:
        res = serve(args.arch, args.batch, args.prompt_len, args.gen,
                    args.layers, args.d_model, args.pim, args.pim_bits,
                    args.pim_emulate, pim_substrate=args.pim_substrate,
                    plan_dir=args.plan_dir, mesh=args.mesh,
                    compile_cache_dir=args.compile_cache_dir,
                    metrics_json=args.metrics_json, stop_tokens=stop_tokens,
                    eos_token=args.eos_token, device=args.device)
        print(f"[serve] prefill {res['prefill_s']*1e3:.1f}ms, "
              f"decode {res['decode_s_per_token']*1e3:.1f}ms/tok")
        print(f"[serve] tokens:\n{res['generated']}")
        if stop_tokens or args.eos_token is not None:
            print(f"[serve] stop reasons: {res['stop_reasons']}")
    if "pim_substrate" in res:
        print(f"[serve] pim_substrate = {res['pim_substrate']}")
    for k, v in res.items():
        if k.startswith("opima_"):
            print(f"[serve] {k} = {v:.4g}")
    if args.metrics_json:
        print(f"[serve] metrics written to {args.metrics_json}")


if __name__ == "__main__":
    main()
