"""Continuous-batching scheduler over the weight-stationary PIM engine
(counterpart of ``repro/serving/scheduler.py``; the policy is plain
Python, the same code).

OPIMA's economics are amortization: weights are programmed into the
optical arrays once (``engine.program``) and pay for themselves under
sustained traffic. This scheduler supplies that traffic shape — requests
with heterogeneous arrival times, prompt lengths, and generation lengths
stream through a *fixed pool of decode slots*, so activations keep moving
past the same stationary plans with no idle lock-step barrier.

The device-facing machinery lives in :class:`repro_torch.serving.engine.
ServingEngine` (the JetStream-style prefill / insert / generate facade);
the scheduler is pure policy on top of those verbs:

  * admission: a ready request claims a free slot; its prompt runs
    through ``engine.start_prefill`` / ``prefill_step`` — one step-function
    call per scheduler iteration, so with chunked prefill a long prompt
    interleaves with decode instead of stalling every active slot — and
    ``engine.insert`` writes its KV into the slot row. With a prefix
    cache, full-prompt or shared-prefix hits skip the recomputation.
  * decode: one ``engine.generate`` dispatch steps *all* occupied slots
    at their own sequence offsets. With ``sync_every=k`` up to k fused
    steps run on the device between host syncs; per-slot masking inside
    the fused window keeps ragged tails (windows shorter than k, slots
    stopping mid-window) fused.
  * retirement: the engine retires a slot the step its sequence finishes
    — trace budget exhausted or a stop token emitted (detected on the
    device) — and the next ready request refills it at the same step
    shapes.

Token-level semantics are identical to the static path: the first
generated token comes from the prefill logits, token ``g`` (g >= 1) from
a decode at position ``prompt_len + g - 1``. On exact substrates the
produced tokens are bit-identical to a static ``prefill`` +
``decode_step`` run of the same request (tested), including under
chunked prefill and prefix-cache hits.

Spans and counters (:mod:`repro_torch.analysis.trace`): one
``sched.iteration`` per loop iteration, holding a ``sched.admit`` (the
request, its slot) per unit of admission work and the engine's spans;
counters ``sched.decode_steps`` and ``sched.occupied_slot_steps``, whose
ratio over the slot count is the run's ``mean_slot_occupancy``.

The scheduler clock is virtual — one decode step advances time by 1.0 —
so latency accounting (TTFT, per-request latency) is deterministic and
trace-replayable; wall-clock throughput is reported alongside. In
budget-only mode the window policy provably never retires a slot
mid-window or skips an admission opportunity, so all virtual accounting
is independent of ``sync_every``. With stop tokens, a slot may stop
mid-window while a request waits — TTFT can shift by at most
``sync_every - 1`` steps against single-stepping (the usual multi-step
scheduling trade).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving.engine import PrefillTask, ServingEngine, SlotView
from repro_torch.serving.stream import (Completion, StreamCallbacks,
                                        TokenCollector)


@dataclasses.dataclass
class Request:
    """One generation request entering the queue."""

    request_id: Hashable
    tokens: np.ndarray           # (prompt_len,) int32 prompt tokens
    max_new_tokens: int          # generation budget (stop tokens may end
    #                              the sequence earlier)
    arrival: float = 0.0         # virtual-clock arrival time (steps)
    shared_prefix_len: int = 0   # shared-prefix boundary (e.g. system
    #                              prompt length) for prefix-cache reuse
    deadline: Optional[float] = None  # absolute virtual-clock deadline:
    #                              once the clock reaches it the request
    #                              retires with stop_reason="deadline"
    #                              (whatever tokens it has), freeing its
    #                              slot — queued, admitting, or live


@dataclasses.dataclass
class RunResult:
    completions: List[Completion]
    metrics: Dict[str, Any]

    def tokens_by_id(self) -> Dict[Hashable, np.ndarray]:
        return {c.request_id: c.tokens for c in self.completions}


def _percentiles(values: Sequence[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
    arr = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)),
            "p99": float(np.percentile(arr, 99))}


def poisson_trace(n: int, rate: float, prompt_lens: Sequence[int],
                  gen_lens: Sequence[int], vocab: int, seed: int = 0,
                  shared_prefix_len: int = 0) -> List[Request]:
    """Synthetic Poisson arrival trace with mixed prompt/generation
    lengths (exponential inter-arrivals at ``rate`` requests per step;
    ``rate <= 0`` means everything arrives at t=0 — a burst).

    ``shared_prefix_len > 0`` prepends one common random prefix of that
    length to every prompt (the shared-system-prompt traffic shape) and
    stamps the boundary on each request for prefix-cache reuse."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=(shared_prefix_len,)).astype(
        np.int32) if shared_prefix_len > 0 else None
    t = 0.0
    out = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.choice(np.asarray(prompt_lens)))
        glen = int(rng.choice(np.asarray(gen_lens)))
        toks = rng.integers(0, vocab, size=(plen,)).astype(np.int32)
        if prefix is not None:
            toks = np.concatenate([prefix, toks])
        out.append(Request(request_id=i, tokens=toks, max_new_tokens=glen,
                           arrival=t, shared_prefix_len=shared_prefix_len))
    return out


def static_generate(params, cfg: ModelConfig, tokens: np.ndarray,
                    max_new_tokens: int, cache_dtype=torch.bfloat16,
                    max_len: Optional[int] = None,
                    prompt_pad: Optional[int] = None, rows: int = 1
                    ) -> np.ndarray:
    """Straight static-batch reference for one request: prefill +
    lock-step ``decode_step`` (the ``launch.serve`` loop). The continuous
    scheduler must reproduce these tokens bit-for-bit on exact substrates
    (truncated at the first stop token, when stopping is
    content-dependent).

    By default this is the JAX package's reference: the unpadded prompt,
    a cache of ``prompt + max_new_tokens`` positions, batch 1. On a card
    a float reduction may pick its order by shape (torch's row
    reductions by the row count, cuBLAS by the problem shape), so the
    comparison there runs the slot geometry's shapes: ``max_len`` sets the
    cache length (the slot cache's), ``prompt_pad`` pads the prompt as the
    engine's whole prefill does (its logits read at the prompt end), and
    ``rows`` decodes the request in a batch of that many copies (the slot
    count). The request's own tokens never depend on the other rows."""
    toks = np.asarray(tokens, np.int64).reshape(-1)
    plen = int(toks.shape[0])
    dev = params["embed_vd"].device
    pad = plen if prompt_pad is None else prompt_pad
    padded = np.zeros((1, pad), np.int64)
    padded[0, :plen] = toks
    max_len = plen + max_new_tokens if max_len is None else max_len
    logits, cache = lm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(padded).to(dev)},
                               max_len=max_len, cache_dtype=cache_dtype,
                               logits_index=plen - 1)
    tok = torch.argmax(logits, -1)[:, None].expand(rows, 1).contiguous()
    cache = {k: v.expand((v.shape[0], rows) + tuple(v.shape[2:]))
             .contiguous() for k, v in cache.items()}
    out = [tok[0, 0]]
    for g in range(1, max_new_tokens):
        logits, cache = lm.decode_step(params, cfg, cache, tok,
                                       plen + g - 1)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok[0, 0])
    # one sync at the end instead of one per generated token
    # repro-lint: disable=RPR101 (the request's one read, after its loop)
    return torch.stack(out).cpu().numpy().astype(np.int32)


class ContinuousScheduler:
    """Iteration-level scheduler: admit -> decode -> retire, forever.

    Every step function is owned by the :class:`ServingEngine`;
    ``prefill_traces`` / ``decode_traces`` proxy its counts of distinct
    step-input shape signatures, so tests and benchmarks can assert that
    the step shapes stay fixed (the JAX engine's compile-once counters).
    ``reliability=`` (a :class:`~repro_torch.reliability.
    ReliabilityManager`) passes to the engine, and the run's metrics gain
    its ``reliability`` section. ``mesh=`` passes to the engine (the
    params' plans split over it), and so does ``sanitizer=`` (a
    :class:`~repro_torch.analysis.sanitize.Sanitizer`: the host-read
    guard around each decode step).
    """

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 prompt_pad: int, max_len: int,
                 max_prefills_per_step: int = 1,
                 cache_dtype=torch.bfloat16, sync_every: int = 1,
                 mesh=None,
                 sanitizer=None,
                 stop_tokens: Sequence[int] = (),
                 eos_token: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: int = 0,
                 admission_policy: str = "fifo",
                 reliability=None):
        if max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        if admission_policy not in ("fifo", "sjf"):
            raise ValueError(
                f"admission_policy must be 'fifo' or 'sjf', got "
                f"{admission_policy!r}")
        self.engine = ServingEngine(
            params, cfg, num_slots=num_slots, prompt_pad=prompt_pad,
            max_len=max_len, cache_dtype=cache_dtype,
            sync_every=sync_every, stop_tokens=stop_tokens,
            eos_token=eos_token, prefill_chunk=prefill_chunk,
            prefix_cache_capacity=prefix_cache, mesh=mesh,
            sanitizer=sanitizer, reliability=reliability)
        self.admission_policy = admission_policy
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.prompt_pad = prompt_pad
        self.max_len = max_len
        self.max_prefills_per_step = max_prefills_per_step
        self.cache_dtype = cache_dtype
        self.sync_every = sync_every
        self.prefill_chunk = self.engine.prefill_chunk

    @property
    def prefill_traces(self) -> int:
        return self.engine.prefill_traces

    @property
    def decode_traces(self) -> int:
        return self.engine.decode_traces

    def warmup(self) -> None:
        """Run every step function once outside any timed window (see
        ``ServingEngine.warmup``). ``serve_continuous`` calls this before
        its metered run so the dumped ``tokens_per_s`` tracks scheduling,
        not first-call costs."""
        self.engine.warmup()

    def _validate(self, requests: Sequence[Request]) -> None:
        seen = set()
        for r in requests:
            if r.request_id in seen:
                raise ValueError(f"duplicate request_id {r.request_id!r}")
            seen.add(r.request_id)
            plen = int(np.asarray(r.tokens).shape[0])
            if plen < 1 or r.max_new_tokens < 1:
                raise ValueError(
                    f"request {r.request_id!r}: need a non-empty prompt "
                    "and max_new_tokens >= 1")
            if plen > self.prompt_pad:
                raise ValueError(
                    f"request {r.request_id!r}: prompt length {plen} "
                    f"exceeds prompt_pad={self.prompt_pad}")
            if plen + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {r.request_id!r}: prompt {plen} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds "
                    f"max_len={self.max_len}")
            if r.arrival < 0:
                raise ValueError(
                    f"request {r.request_id!r}: negative arrival time")
            if not (0 <= r.shared_prefix_len <= plen):
                raise ValueError(
                    f"request {r.request_id!r}: shared_prefix_len "
                    f"{r.shared_prefix_len} outside [0, {plen}]")
            if r.deadline is not None and r.deadline <= r.arrival:
                raise ValueError(
                    f"request {r.request_id!r}: deadline {r.deadline} "
                    f"must be after arrival {r.arrival}")

    # ------------------------------------------------------------------
    # admission-policy cost estimates (prefill units == step calls)
    # ------------------------------------------------------------------
    def _req_units(self, req: Request) -> int:
        """Prefill units a not-yet-started request will need (upper
        bound: a prefix-cache hit may shorten it)."""
        if self.prefill_chunk is None:
            return 1
        plen = int(np.asarray(req.tokens).shape[0])
        return max(-(-plen // self.prefill_chunk), 1)

    @staticmethod
    def _task_units_left(task: PrefillTask) -> int:
        """Prefill units an in-flight task still needs."""
        if task.finished:
            return 0
        if not task.phases:          # single-shot prefill: one call
            return 1
        total = sum(len(starts) for _, starts in task.phases)
        phase, idx = task.cursor
        done = sum(len(task.phases[p][1]) for p in range(phase)) + idx
        return max(total - done, 1)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request],
            callbacks: Optional[StreamCallbacks] = None) -> RunResult:
        """Serve every request to completion; returns completions plus
        aggregate metrics. Reusable: each call builds a fresh
        ``DecodeState`` on the same engine."""
        self._validate(requests)
        engine = self.engine
        cb = callbacks if callbacks is not None else TokenCollector()
        pending = deque(sorted(
            requests, key=lambda r: (r.arrival, str(r.request_id))))
        state = engine.init_state()
        ready: List[Request] = []
        # in-flight (possibly chunked) prefills, FIFO; slot is reserved
        # at task start so concurrent tasks can never oversubscribe
        admitting: List[Tuple[Request, PrefillTask, int]] = []
        # slot -> (request, admit_step, first_token_wall_s)
        live: Dict[int, Tuple[Request, float, float]] = {}
        completions: List[Completion] = []
        step = 0.0
        decode_steps = prefills = host_syncs = prefill_units = 0
        occupancy_acc = 0
        reasons = {"budget": 0, "eos": 0, "stop_token": 0, "deadline": 0}
        t0 = time.time()

        def finish(view: SlotView, req: Request, admit_at: float,
                   first_wall: float, at: float) -> None:
            reason = view.stop_reason or "budget"
            reasons[reason] += 1
            comp = Completion(
                request_id=req.request_id,
                prompt=np.asarray(req.tokens, np.int32),
                tokens=np.asarray(view.tokens, np.int32),
                arrival_step=req.arrival, admit_step=admit_at,
                finish_step=at, slot=view.slot, stop_reason=reason,
                first_token_wall_s=first_wall,
                finish_wall_s=time.time() - t0)
            completions.append(comp)
            cb.on_finish(comp)

        def expire_unstarted(req: Request, slot: int, at: float) -> None:
            # deadline passed before any token was produced: retire with
            # an empty completion (admit_step==finish_step==now)
            reasons["deadline"] += 1
            comp = Completion(
                request_id=req.request_id,
                prompt=np.asarray(req.tokens, np.int32),
                tokens=np.zeros((0,), np.int32),
                arrival_step=req.arrival, admit_step=at,
                finish_step=at, slot=slot, stop_reason="deadline",
                first_token_wall_s=0.0,
                finish_wall_s=time.time() - t0)
            completions.append(comp)
            cb.on_finish(comp)

        def sweep_deadlines(now: float) -> None:
            """Retire every request whose deadline the virtual clock has
            reached — queued, mid-prefill, or live. Reserved slots are
            freed, so an expiring request can never leak one; live slots
            keep the tokens generated so far (enforcement is at scheduler
            granularity: a fused decode window may overrun the deadline
            by at most its clamped length)."""
            for r in [r for r in ready
                      if r.deadline is not None and now >= r.deadline]:
                ready.remove(r)
                expire_unstarted(r, -1, now)
            for entry in [e for e in admitting
                          if e[0].deadline is not None
                          and now >= e[0].deadline]:
                req, _task, slot = entry
                admitting.remove(entry)
                state.alloc.free(slot)
                expire_unstarted(req, slot, now)
            for slot in [s for s, v in live.items()
                         if v[0].deadline is not None
                         and now >= v[0].deadline]:
                req, admit_at, first_wall = live.pop(slot)
                view = state.slots.pop(slot)
                state.alloc.free(slot)
                view.done = True
                view.stop_reason = "deadline"
                finish(view, req, admit_at, first_wall, now)

        while pending or ready or admitting or state.slots:
            with trace.span("sched.iteration"):
                while pending and pending[0].arrival <= step:
                    ready.append(pending.popleft())
                sweep_deadlines(step)
                if not ready and not admitting and not state.slots:
                    if not pending:
                        break        # the sweep drained the last request
                    step = pending[0].arrival   # idle: jump to next arrival
                    continue
                # --- admission: up to max_prefills_per_step units of
                # prefill work per iteration — one unit == one step call,
                # so a chunked long prompt spreads across iterations and
                # decode keeps running in between. Under "fifo", in-flight
                # tasks advance first and ready requests claim free slots
                # only when nothing is in flight. Under "sjf", a short
                # ready request may open its own task while a long chunked
                # admission is still in flight (slots permitting), and the
                # in-flight task with the fewest remaining prefill units
                # advances first — so a one-chunk prompt is not stuck
                # behind a 16-chunk one.
                sjf = self.admission_policy == "sjf"
                units = 0
                while units < self.max_prefills_per_step:
                    start_new = bool(ready) and (
                        not admitting or
                        (sjf and state.alloc.num_free > 0 and
                         min(self._req_units(r) for r in ready) <
                         min(self._task_units_left(t)
                             for _, t, _ in admitting)))
                    if start_new:
                        pick = (min(range(len(ready)),
                                    key=lambda i: (
                                        self._req_units(ready[i]), i))
                                if sjf else 0)
                        slot = state.alloc.alloc(ready[pick].request_id)
                        if slot is None:
                            if not admitting:
                                break
                        else:
                            req = ready.pop(pick)
                            task = engine.start_prefill(
                                req.tokens, req.shared_prefix_len,
                                request_id=req.request_id)
                            admitting.append((req, task, slot))
                    if not admitting:
                        break
                    ei = (min(range(len(admitting)),
                              key=lambda j: (
                                  self._task_units_left(admitting[j][1]), j))
                          if sjf else 0)
                    req, task, slot = admitting[ei]
                    # one unit of a request's admission: its prefill step and,
                    # once the prefill is done, its insert
                    with trace.span("sched.admit", request=req.request_id,
                                    slot=slot):
                        done = engine.prefill_step(task)
                        units += 1
                        prefill_units += 1
                        if done:
                            admitting.pop(ei)
                            state, view = engine.insert(
                                task.prefix, state,
                                max_new_tokens=req.max_new_tokens,
                                request_id=req.request_id, slot=slot)
                            prefills += 1
                            admit_at = step + 1.0
                            first_wall = time.time() - t0
                            cb.on_admit(req.request_id, slot, admit_at)
                            cb.on_token(req.request_id, view.tokens[0], 0)
                            if view.done:
                                # budget of one — or the prefill token
                                # itself is a stop token: complete
                                # without a decode step
                                finish(view, req, admit_at, first_wall,
                                       admit_at)
                            else:
                                live[slot] = (req, admit_at, first_wall)
                # --- decode over all occupied slots -------------------------
                # With sync_every > 1, up to a full window of fused decode
                # steps runs on-device between host syncs. The bound keeps
                # the virtual accounting exact in budget-only mode: no slot
                # may exhaust its budget mid-window and no admission
                # opportunity may be skipped. Ragged windows (2..k-1) run
                # *fused* through the masked window — the per-slot validity
                # mask freezes rows past the bound, so tokens and latency
                # accounting match single-stepping while the host syncs once.
                active_n = len(state.slots)
                if state.slots:
                    window = 1
                    if self.sync_every > 1:
                        window = min(self.sync_every,
                                     min(v.budget_left
                                         for v in state.slots.values()))
                        if admitting:
                            window = 1   # chunk-per-step interleave
                        elif state.alloc.num_free > 0:
                            if ready:
                                window = 1
                            elif pending:
                                window = min(window, max(1, int(np.ceil(
                                    pending[0].arrival - step))))
                        # never fuse past a live request's deadline: the
                        # sweep retires at host-sync granularity, so the
                        # window must stop where the earliest deadline lands
                        dls = [v[0].deadline - step for v in live.values()
                               if v[0].deadline is not None]
                        if dls:
                            window = min(window,
                                         max(1, int(np.ceil(min(dls)))))
                        window = max(1, window)
                    state, res = engine.generate(state, max_steps=window)
                    host_syncs += 1
                    decode_steps += res.steps
                    occupancy_acc += res.steps * active_n
                    trace.count("sched.decode_steps", res.steps)
                    trace.count("sched.occupied_slot_steps",
                                res.steps * active_n)
                    for ev in res.events:
                        cb.on_token(ev.request_id, ev.token, ev.index)
                    for view, i_last in res.finished:
                        req, admit_at, first_wall = live.pop(view.slot)
                        finish(view, req, admit_at, first_wall,
                               step + i_last + 1.0)
                    step += float(res.steps)
                else:
                    step += 1.0

        wall_s = time.time() - t0
        if engine.reliability is not None:
            engine.reliability.deadline_expiries = reasons["deadline"]
        if state.alloc.num_active:
            raise AssertionError(
                f"slot leak: {state.alloc.num_active} slots still "
                f"allocated after the queue drained "
                f"({state.alloc.active_slots()})")
        total_tokens = int(sum(c.tokens.shape[0] for c in completions))
        ttfts = [c.ttft_steps for c in completions]
        lats = [c.latency_steps for c in completions]
        metrics: Dict[str, Any] = {
            "mode": "continuous",
            "num_requests": len(completions),
            "num_slots": self.num_slots,
            "prompt_pad": self.prompt_pad,
            "max_len": self.max_len,
            "prefills": prefills,
            "prefill_units": prefill_units,
            "prefill_chunk": self.prefill_chunk or 0,
            "decode_steps": decode_steps,
            "sync_every": self.sync_every,
            "host_syncs": host_syncs,
            "prefill_traces": engine.prefill_traces,
            "insert_traces": engine.insert_traces,
            "decode_traces": engine.decode_traces,
            "generated_tokens": total_tokens,
            "admission_policy": self.admission_policy,
            "stop_reasons": dict(reasons),
            "deadline_expiries": reasons["deadline"],
            "fallback_traces": engine.fallback_traces,
            "reliability": (engine.reliability.metrics()
                            if engine.reliability is not None else None),
            "prefix_cache": (engine.prefix_cache.stats()
                             if engine.prefix_cache is not None else None),
            "wall_s": wall_s,
            "tokens_per_s": total_tokens / wall_s if wall_s > 0 else 0.0,
            "mean_slot_occupancy": (
                occupancy_acc / (decode_steps * self.num_slots)
                if decode_steps else 0.0),
        }
        for name, vals in (("ttft_steps", ttfts), ("latency_steps", lats)):
            for pk, pv in _percentiles(vals).items():
                metrics[f"{name}_{pk}"] = pv
        for pk, pv in _percentiles(
                [c.first_token_wall_s for c in completions]).items():
            metrics[f"first_token_wall_s_{pk}"] = pv
        return RunResult(completions=completions, metrics=metrics)
