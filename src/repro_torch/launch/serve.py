"""LM serving, static mode (counterpart of ``repro/launch/serve.py``):
one batch of prompts, prefill, then lock-step greedy decode, with
optional OPIMA-PIM weight execution.

With ``--pim``, the attention (q/k/v/o) and MLP (up/gate/down)
projections of every layer are *programmed once* into planned 'OPCM'
form through :mod:`repro_torch.engine` (4-bit cells by default,
nibble-decomposed and pre-padded), one ``DensePlan`` per layer, and the
serving matmuls drive activations past them on the substrate named by
``--pim-substrate`` (default ``exact-cuda``, the hand-written kernel; the
JAX names are accepted). Weights the engine does not cover (SSM
projections, embedding tables) are fake-quantized instead, so every
substrate still models their cell-density quantization. An OPIMA
hardware latency/energy estimate for the request batch is reported next
to the wall-clock numbers.

Not ported yet, and raising: ``--continuous`` and the compile cache
(ROADMAP A7), ``--plan-dir`` (A8), ``--mesh`` (A11), ABFT (A9).

Run (full width, on the card; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --batch 8 --prompt-len 512 --gen 16 --pim
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
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
from repro_torch.models.lm import decode_step, init_lm, prefill
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
    if not any(k in _PLANNED_BLOCKS for k in keys):
        return False
    ndim = x.dim() if torch.is_tensor(x) else 0
    return ((name.endswith(_PLANNED_PROJ_SUFFIXES) and ndim == 3) or
            (name.endswith(_EXPERT_STACK_SUFFIXES) and ndim == 4))


def _quantizable(name: str, x) -> bool:
    return (torch.is_tensor(x) and x.dim() >= 2 and
            name.endswith(PIM_WEIGHT_SUFFIXES))


def plan_params_for_pim(params, cfg: PimConfig):
    """Program the deployable weights into planned 'OPCM' form.

    Each layer-stacked (L, K, N) projection of the attention and MLP
    blocks becomes a list of L :class:`~repro_torch.core.pim.DensePlan`,
    one per layer, programmed from the original float weights on the
    substrate ``cfg`` names (quantize + nibble-decompose + kernel pre-pad,
    once). ``lm.layer_trees`` takes the list's entries per layer and
    ``layers.proj`` dispatches each plan onto the engine. Every other
    ``PIM_WEIGHT_SUFFIXES`` leaf of two or more dimensions (SSM
    projections, embedding tables) is fake-quantized per output column,
    with the JAX package's predicates."""
    sub = engine.get_substrate(cfg.resolved_substrate)

    def plan_stack(v):
        return [sub.program(v[i], cfg) for i in range(v.shape[0])]

    def walk(tree, keys, plan):
        out = {}
        for k, v in tree.items():
            path = keys + [k]
            if isinstance(v, dict):
                out[k] = walk(v, path, plan)
            elif _will_plan(path, k, v):
                if v.dim() == 4:
                    raise NotImplementedError(
                        f"{'/'.join(path)}: expert-stacked plans are not "
                        "ported yet (ROADMAP A2/A6)")
                # programmed from the float weights, never fake-quantized
                out[k] = plan_stack(v) if plan else v
            elif _quantizable(k, v):
                out[k] = fake_quantize(v, cfg.weight_bits,
                                       axis=(v.dim() - 2,))
            else:
                out[k] = v
        return out

    out = walk(params, [], plan=False)
    for layers_key in ("layers", "enc_layers"):
        if layers_key not in params:
            continue
        layers = dict(out[layers_key])
        for blk in _PLANNED_BLOCKS:
            if blk in layers:
                layers[blk] = walk(params[layers_key][blk],
                                   [layers_key, blk], plan=True)
        out[layers_key] = layers
    return out


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


def _not_ported(plan_dir, mesh_spec, compile_cache_dir) -> None:
    if plan_dir:
        raise NotImplementedError(
            "plan_dir: plan persistence is not ported yet (ROADMAP A8)")
    if mesh_spec:
        raise NotImplementedError(
            "mesh: sharded serving is not ported yet (ROADMAP A11)")
    if compile_cache_dir:
        raise NotImplementedError(
            "compile_cache_dir: the port runs eagerly and has no compile "
            "cache; serving features beyond static mode come with ROADMAP "
            "A7")


def _setup(arch: str, layers: Optional[int], d_model: Optional[int],
           pim: bool, pim_bits: int, pim_emulate: bool,
           pim_substrate: Optional[str], plan_dir: Optional[str],
           mesh_spec: Optional[str] = None,
           compile_cache_dir: Optional[str] = None, abft: str = "off",
           device=None):
    """Serve bring-up: config reduction, parameter init (random, seed 0)
    and, with ``pim``, weight programming. Returns
    ``(cfg, params, substrate, pim_cfg, mesh)``; ``mesh`` is always None
    in the port."""
    _not_ported(plan_dir, mesh_spec, compile_cache_dir)
    device = resolve_device(device)
    cfg = get_config(arch)
    if layers or d_model:
        cfg = cfg.reduced(num_layers=layers or 2, d_model=d_model or 64,
                          vocab=min(cfg.vocab_size, 512))
    params = init_lm(cfg, 0, device=device)
    substrate = _resolve_substrate(pim_substrate, pim_emulate)
    pim_cfg = PimConfig(weight_bits=pim_bits, act_bits=pim_bits,
                        substrate=substrate, verify=abft)
    if pim:
        params = plan_params_for_pim(params, pim_cfg)
    return cfg, params, substrate, pim_cfg, None


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
                    help="not ported yet (ROADMAP A8)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="not ported yet (ROADMAP A11)")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="not ported yet (ROADMAP A7)")
    ap.add_argument("--continuous", action="store_true",
                    help="not ported yet (ROADMAP A7)")
    ap.add_argument("--stop-tokens", default=None, metavar="T1,T2,...",
                    help="comma-separated stop-token ids; rows are "
                         "truncated post hoc")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="EOS token id (reported as stop_reason='eos')")
    ap.add_argument("--metrics-json", default=None,
                    help="write the structured run metrics to this path")
    args = ap.parse_args()
    if args.continuous:
        raise NotImplementedError(
            "--continuous: continuous batching is not ported yet "
            "(ROADMAP A7)")
    stop_tokens = tuple(
        int(t) for t in args.stop_tokens.split(",") if t.strip()
    ) if args.stop_tokens else ()
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
