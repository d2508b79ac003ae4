"""JetStream-style serving engine facade: prefill / insert / generate
(counterpart of ``repro/serving/engine.py``).

The :class:`ServingEngine` is the production API over the continuous-
batching machinery: callers speak in three verbs and never touch slots,
caches, or step functions directly —

  * ``prefill(tokens) -> Prefix`` — run the prompt through the model and
    return its KV block plus the greedy first token. Long prompts split
    into fixed-size chunks (``prefill_chunk=C``) so a long prompt
    interleaves with decode instead of stalling every active slot; with a
    prefix cache, requests sharing a system prompt reuse its KV instead
    of re-running prefill.
  * ``insert(prefix, state) -> (state, view)`` — claim a slot and write
    the Prefix KV into the slot cache's row.
  * ``generate(state) -> (state, result)`` — one decode dispatch over all
    occupied slots: every slot steps at its own offset, stop tokens are
    detected on the device, and finished slots retire the step their
    sequence ends.

Production semantics underneath:

  content-dependent stopping — the decode step computes a per-slot stop
  mask (``lm.token_stop_mask`` over the engine's EOS + stop-token set) on
  the device, so a fused multi-step window freezes a finished row
  without a host round-trip.

  chunked prefill — chunks run through ``lm.prefill_chunk`` into a
  scratch KV cache held in the *compute* dtype and sized exactly
  ``prompt_pad``, with chunk starts clamped to ``P - C`` (clamped chunks
  recompute a deterministic overlap). Both choices are load-bearing for
  bit-identity with single-shot prefill: the attention reduction length
  stays P in every chunk (a reduction's order may depend on its length),
  and masked entries contribute exactly 0.0.

  shared-prefix KV reuse — a content-hashed :class:`PrefixCache`: exact
  full-prompt hits skip prefill entirely; shared-prefix hits seed the
  scratch and only the tail chunks run (``Request.shared_prefix_len``
  marks the boundary). The port writes caches in place, so a cached
  block is a clone of the scratch, and a hit seeds a clone of the entry.

  masked decode window — ``generate(max_steps=w)`` with w > 1 runs w
  decode steps on the device between host syncs, each under a per-slot
  validity mask ``~done`` (budget and stop tokens update ``done`` on the
  device): ragged tails and mid-window stops stay fused. Frozen rows
  re-feed their last token at their last position — a deterministic
  identical KV rewrite, so the cache stays bit-exact.

  ABFT-verified serving — with a
  :class:`~repro_torch.reliability.ReliabilityManager` (``reliability=``)
  the engine serves its (possibly fault-injected) params and runs every
  dispatch inside an ABFT collect scope: each verified matmul's
  violation count stays on the device, the dispatch's per-tag sums come
  to the host in the same copy as its tokens (no host sync per matmul)
  and go to the fault log; a dispatch that tripped is replayed on the
  manager's golden exact fallback from the pre-dispatch state, then the
  manager may re-program plans (the prefix cache is flushed) or pin the
  engine to the fallback. Counts are delivered on every dispatch,
  manager or not, as the JAX engine's ``_verified_jit`` does.

The port runs its step functions eagerly, so nothing is compiled:
``prefill_traces`` / ``decode_traces`` / ``insert_traces`` count the
distinct step-input shape signatures run (prefill and chunk calls,
single steps and windows, inserts), and ``fallback_traces`` those of the
fallback replays (warm-up included): the counterpart of the JAX engine's
compile-once counters; on fixed slot geometry each stays 1 (decode, 2
with windows). Each new signature is also told to the armed
:class:`~repro_torch.analysis.sanitize.CompileCounter`, under the JAX
engine's jit names (``prefill``, ``prefill_chunk``, ``insert``,
``decode``, ``decode_window``; ``<name>_fb`` for a fallback replay).

Sanitizers (``sanitizer=``, a duck-typed
:class:`~repro_torch.analysis.sanitize.Sanitizer`): its ``decode_guard``
wraps each decode step call (``_decode_fn`` / ``_window_fn``) inside the
dispatch, so a blocking host read there raises. The placement of the
step's inputs before it and ``_fetch``'s one copy after it stay outside,
and a fallback replay runs unguarded, as in the JAX engine. Inside its
``session()``, ``nan_debug`` folds a NaN count of each dispatch's float
outputs into that one copy, and a NaN raises ``FloatingPointError``.

Spans and counters (:mod:`repro_torch.analysis.trace`, recorded while a
recorder is armed): ``engine.prefill`` / ``engine.prefill_chunk`` (the
request, the rows run) and ``engine.insert`` (the request, its slot);
``engine.generate`` (the slots stepped, their requests, the steps) around
each decode dispatch; inside any dispatch ``engine.place`` (each placement
of step inputs on the device), ``engine.step`` (the step call),
``engine.fetch`` (the one device-to-host copy, where the host waits for
the device) and ``engine.replay`` (an ABFT fallback replay); counters
``engine.prefill_rows`` and ``engine.prompt_tokens``.

Meshes (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh`): every rank
runs the engine over params whose plans are split over the mesh
(:mod:`repro_torch.engine.mesh`), and each split matmul hands every rank
the whole output, so the engine's verbs are unchanged. Each rank holds the
whole slot cache; the JAX engine places the cache's slot axis over the
data axes, which is placement only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.analysis import trace
from repro_torch.analysis.sanitize import record_compile
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.reliability import abft
from repro_torch.serving import slots as slots_mod
from repro_torch.serving.prefix import (Prefix, PrefixCache, PrefixEntry,
                                        token_key)


@dataclasses.dataclass
class SlotView:
    """Host-side view of one in-flight request (the engine's record of a
    slot between ``insert`` and retirement)."""

    request_id: Hashable
    slot: int
    prompt_len: int
    pos: int                     # next cache write position
    tokens: List[int]            # generated so far (index 0 from prefill)
    max_new_tokens: int
    done: bool = False
    stop_reason: Optional[str] = None   # "eos" | "stop_token" | "budget"
    #                                     | "deadline" (scheduler-set)

    @property
    def budget_left(self) -> int:
        return self.max_new_tokens - len(self.tokens)


@dataclasses.dataclass
class DecodeState:
    """Everything traffic-dependent: the slot cache, the allocator, and
    the per-slot views. The engine itself stays request-free, so one
    engine serves many independent runs."""

    cache: Any
    alloc: slots_mod.SlotAllocator
    slots: Dict[int, SlotView]

    @property
    def num_free(self) -> int:
        return self.alloc.num_free


@dataclasses.dataclass
class TokenEvent:
    """One emitted token inside a ``generate`` call, in deterministic
    step-major / slot-minor order. ``step_offset`` is the 0-based decode
    iteration within the dispatched window that produced it."""

    request_id: Hashable
    slot: int
    token: int
    index: int                   # position within the generated sequence
    step_offset: int


@dataclasses.dataclass
class StepResult:
    """Outcome of one ``generate`` dispatch."""

    events: List[TokenEvent]
    finished: List[Tuple[SlotView, int]]  # (retired view, last step_offset)
    steps: int                   # decode iterations dispatched (window len)


class PrefillTask:
    """Host-side cursor for one (possibly chunked) prefill. Created by
    ``start_prefill``; ``prefill_step`` advances it one step-function call
    at a time so the scheduler can interleave prompt chunks with decode
    steps. ``prefix`` is set once ``finished``."""

    def __init__(self, tokens: np.ndarray, shared_prefix_len: int = 0,
                 request_id: Hashable = None):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.length = int(self.tokens.shape[0])
        self.shared_prefix_len = shared_prefix_len
        self.request_id = request_id      # carried by its spans
        self.key = token_key(self.tokens)
        self.prefix: Optional[Prefix] = None
        # chunked-mode cursor state (filled in by the engine)
        self.scratch: Any = None
        self.phases: List[Tuple[np.ndarray, List[int]]] = []
        self.cursor = (0, 0)                 # (phase, chunk-within-phase)
        self.prefix_key: Optional[str] = None  # snapshot after phase 0

    @property
    def finished(self) -> bool:
        return self.prefix is not None


# step name (the JAX engine's jit name) -> its signature set
_STEP_KINDS = {"prefill": "prefill", "prefill_chunk": "prefill",
               "insert": "insert", "decode": "decode",
               "decode_window": "decode"}


class ServingEngine:
    """The serving facade. One instance binds params + config + slot
    geometry and owns every step function; traffic lives in
    :class:`DecodeState` objects created by :meth:`init_state`. The
    params' device is the engine's. ``reliability`` (a duck-typed
    :class:`~repro_torch.reliability.ReliabilityManager`) arms
    ABFT-verified serving with retry on its fallback, repair and
    degraded mode; the engine then serves ``reliability.serving_params()``.
    ``mesh`` is the mesh the params' plans were split over (recorded; the
    split plans carry it themselves). ``sanitizer`` arms the runtime
    sanitizers (see the module docstring).
    """

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 prompt_pad: int, max_len: int,
                 cache_dtype=torch.bfloat16, sync_every: int = 1,
                 stop_tokens: Sequence[int] = (),
                 eos_token: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_capacity: int = 0,
                 mesh=None, sanitizer=None, reliability=None):
        slots_mod.check_slot_compatible(cfg)
        if prompt_pad > max_len:
            raise ValueError(f"prompt_pad={prompt_pad} exceeds "
                             f"max_len={max_len}")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            prefill_chunk = min(prefill_chunk, prompt_pad)
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.sanitizer = sanitizer
        self.num_slots = num_slots
        self.prompt_pad = prompt_pad
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.sync_every = sync_every
        self.prefill_chunk = prefill_chunk
        self.eos_token = int(eos_token) if eos_token is not None else None
        self._user_stops = {int(t) for t in stop_tokens}
        stop_set = set(self._user_stops)
        if self.eos_token is not None:
            stop_set.add(self.eos_token)
        self._stop_set = stop_set
        # scratch/prefill compute dtype: the model dtype, so chunked
        # attention reads exactly the values single-shot prefill computes
        table = params["embed_vd"]
        self.device = table.device
        self._compute_dtype = table.dtype
        # the device-side stop set: (K,) with K == 0 meaning stopping is
        # budget-only (token_stop_mask returns all-False)
        self._stop_arr = torch.tensor(sorted(stop_set), dtype=torch.int32,
                                      device=self.device)
        self.prefix_cache = (PrefixCache(prefix_cache_capacity)
                             if prefix_cache_capacity else None)
        self.reliability = reliability
        if reliability is not None:
            self.params = reliability.serving_params()
        self._signatures: Dict[str, set] = {"prefill": set(),
                                            "insert": set(),
                                            "decode": set(),
                                            "fallback": set()}

    # ------------------------------------------------------------------
    # step-input shape signatures (the compile-once counters' meaning)
    # ------------------------------------------------------------------
    @property
    def prefill_traces(self) -> int:
        return len(self._signatures["prefill"])

    @property
    def insert_traces(self) -> int:
        return len(self._signatures["insert"])

    @property
    def decode_traces(self) -> int:
        return len(self._signatures["decode"])

    @property
    def fallback_traces(self) -> int:
        return len(self._signatures["fallback"])

    def _note(self, name: str, fallback: bool, *shapes) -> None:
        """Record the input signature of step ``name``: under its kind,
        or, for a fallback replay, under "fallback" keyed by the kind too.
        A new signature is one compile for the armed compile counters."""
        kind = _STEP_KINDS[name]
        sig = tuple(tuple(s) for s in shapes)
        key, sig = ("fallback", (kind,) + sig) if fallback else (kind, sig)
        if sig not in self._signatures[key]:
            self._signatures[key].add(sig)
            record_compile(f"{name}_fb" if fallback else name)

    # ------------------------------------------------------------------
    # step functions
    # ------------------------------------------------------------------
    def _prefill_fn(self, params, toks: torch.Tensor, length: int,
                    fallback: bool = False):
        self._note("prefill", fallback, toks.shape)
        logits, pcache = lm.prefill(
            params, self.cfg, {"tokens": toks}, max_len=self.prompt_pad,
            cache_dtype=self.cache_dtype, logits_index=length - 1)
        tok0 = torch.argmax(logits, -1)[0]
        return tok0, {"k": pcache["k"], "v": pcache["v"]}

    def _chunk_fn(self, params, scratch, toks: torch.Tensor, start: int,
                  li: int, fallback: bool = False):
        """One chunk into ``scratch``, written in place."""
        self._note("prefill_chunk", fallback, toks.shape,
                   scratch["k"].shape)
        logits, scratch = lm.prefill_chunk(params, self.cfg, scratch, toks,
                                           start, logits_index=li)
        return torch.argmax(logits, -1)[0], scratch

    def _insert_fn(self, cache, kv, slot: int, length: int):
        self._note("insert", False, kv["k"].shape, cache["k"].shape)
        return slots_mod.write_prefill(cache, kv, slot, length)

    def _decode_fn(self, params, cache, toks, pos, fallback: bool = False):
        self._note("decode", fallback, toks.shape, pos.shape)
        logits, cache = lm.decode_step(params, self.cfg, cache, toks, pos)
        nxt = torch.argmax(logits, -1)
        return nxt, lm.token_stop_mask(nxt, self._stop_arr), cache

    def _window_fn(self, params, cache, toks, pos, done, left,
                   window_len: int, fallback: bool = False):
        """``window_len`` fused decode steps (sync_every > 1) between host
        syncs. Step i only advances rows that are not done (budget and
        stop tokens flip ``done`` on the device the step they are
        reached); frozen rows recompute their previous step verbatim
        (same token, same position -> bit-identical KV rewrite), so
        nothing after a stop token is ever marked valid."""
        self._note("decode_window", fallback, toks.shape, pos.shape,
                   done.shape, left.shape)
        toks_seq, valid_seq = [], []
        for _ in range(window_len):
            logits, cache = lm.decode_step(params, self.cfg, cache, toks,
                                           pos)
            nxt = torch.argmax(logits, -1)
            active = ~done
            stop = lm.token_stop_mask(nxt, self._stop_arr)
            left = torch.where(active, left - 1, left)
            done = done | (active & (stop | (left <= 0)))
            toks = torch.where(active[:, None], nxt[:, None], toks)
            pos = torch.where(active, pos + 1, pos)
            toks_seq.append(nxt)
            valid_seq.append(active)
        return torch.stack(toks_seq), torch.stack(valid_seq), cache

    # ------------------------------------------------------------------
    # state + warmup
    # ------------------------------------------------------------------
    def init_state(self) -> DecodeState:
        """Fresh traffic state: zeroed slot cache, empty allocator, no
        views."""
        cache = slots_mod.init_slot_cache(self.cfg, self.num_slots,
                                          self.max_len, self.cache_dtype,
                                          device=self.device)
        return DecodeState(cache=cache,
                           alloc=slots_mod.SlotAllocator(self.num_slots),
                           slots={})

    def _init_scratch(self):
        """Chunked-prefill scratch KV: compute dtype, length exactly
        ``prompt_pad`` (see module docstring on why the length matters
        for bit-identity)."""
        return lm.init_cache(self.cfg, 1, self.prompt_pad,
                             dtype=self._compute_dtype, device=self.device)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        with trace.span("engine.place"):
            return torch.from_numpy(np.asarray(arr, np.int64)).to(
                self.device)

    def _warm(self, params, fallback: bool) -> None:
        """Each step function this engine uses, once, on ``params``."""
        cache = self.init_state().cache
        if self.prefill_chunk is not None:
            (tok0, kv), scope = self._dispatch(
                self._chunk_fn, params, self._init_scratch(),
                self._tokens(np.zeros((1, self.prefill_chunk))), 0, 0,
                fallback)
        else:
            (tok0, kv), scope = self._dispatch(
                self._prefill_fn, params,
                self._tokens(np.zeros((1, self.prompt_pad))), 1, fallback)
        self._fetch([tok0], scope)
        cache = self._insert_fn(cache, kv, 0, 1)
        tok_vec = self._tokens(np.zeros((self.num_slots, 1)))
        pos_vec = self._tokens(np.zeros((self.num_slots,)))
        (nxt, _, cache), scope = self._dispatch(
            self._decode_fn, params, cache, tok_vec, pos_vec, fallback)
        self._fetch([nxt], scope)
        if self.sync_every > 1:
            done = torch.zeros((self.num_slots,), dtype=torch.bool,
                               device=self.device)
            left = self._tokens(np.full((self.num_slots,),
                                        self.sync_every))
            (toks_seq, _, cache), scope = self._dispatch(
                self._window_fn, params, cache, tok_vec, pos_vec, done,
                left, self.sync_every, fallback)
            self._fetch([toks_seq], scope)

    def warmup(self) -> None:
        """Run every step function this engine will use once, outside any
        timed window, against throwaway buffers (first-call costs: the
        kernels' libraries, cuBLAS handles, the caching allocator). With
        a reliability manager the fallback verbs run once too, so a
        replay in the serving loop pays no first call, and whatever the
        warm-up tripped is drained (the machine starts clean)."""
        self._warm(self.params, False)
        if self.reliability is not None:
            self._warm(self.reliability.fallback, True)
            self.reliability.drain()

    # ------------------------------------------------------------------
    # dispatch: ABFT counts collected per dispatch, fetched with its
    # tokens; the degradation machine around every verified dispatch
    # ------------------------------------------------------------------
    @staticmethod
    def _dispatch(fn, *args, guard=None):
        """Run one step function inside an ABFT collect scope: every
        verified matmul's count stays on the device. ``guard`` (a context
        manager) wraps the step call alone. Returns the output and the
        closed scope (its tags and per-tag count vector)."""
        with abft.collect_scope() as scope, trace.span("engine.step"):
            with guard if guard is not None else contextlib.nullcontext():
                out = fn(*args)
        return out, scope

    @staticmethod
    def _fetch(tensors: Sequence[torch.Tensor],
               scope: abft.CollectScope,
               nan_of: Sequence[torch.Tensor] = ()) -> List[np.ndarray]:
        """The dispatch's one device-to-host copy: ``tensors`` (integer or
        bool, as int64) and the scope's per-tag counts together; the
        counts go to the fault log. With ``nan_of`` (float tensors), their
        NaN count rides along, and a NaN raises ``FloatingPointError``.
        Nothing to read means no sync."""
        if not (tensors or scope.names or nan_of):
            return []
        parts = [t.reshape(-1).to(torch.int64) for t in tensors]
        if scope.names:
            parts.append(scope.counts().to(torch.int64))
        if nan_of:
            parts.append(torch.stack([torch.isnan(t).sum() for t in nan_of])
                         .sum().reshape(1))
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        with trace.span("engine.fetch"):
            # repro-lint: disable=RPR101 (the dispatch's one sanctioned read)
            host = flat.cpu().numpy()
        out, at = [], 0
        for t in tensors:
            out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        if scope.names:
            abft.deliver(scope.names, host[at:at + len(scope.names)])
        if nan_of and host[-1]:
            raise FloatingPointError(
                f"NaN in a dispatch's float outputs ({int(host[-1])} "
                "values; the sanitizer's nan_debug)")
        return out

    def _nan_inputs(self, out) -> List[torch.Tensor]:
        """The float tensors of a dispatch's output when the sanitizer's
        NaN check is armed, else none."""
        if self.sanitizer is None or not self.sanitizer.nan_armed:
            return []
        return [t for t in tree.leaves(out)
                if torch.is_tensor(t) and t.is_floating_point()]

    def _after_violation(self) -> None:
        """Post-retry bookkeeping: re-program plans whose strike count
        came due; a repair changes the live params, so the prefix cache
        (KV is a function of tokens AND params) is flushed and the engine
        rebinds the repaired tree."""
        man = self.reliability
        if man.maybe_repair():
            self.params = man.params
            if self.prefix_cache is not None:
                self.prefix_cache.invalidate_all()

    def _checked(self, run, reads, restore=None, guarded: bool = False):
        """One dispatch under the degradation machine. ``run(params,
        fallback)`` dispatches the step; ``reads(out)`` names the tensors
        the host reads from it. Without a manager, or with a degraded one,
        the step runs once (on the fallback when degraded). Otherwise the
        manager drains after it, and a dispatch that tripped is replayed
        on the golden fallback, after ``restore()`` (if given) has put
        back what the dispatch wrote in place. ``guarded`` runs the first
        dispatch's step under the sanitizer's decode guard (a replay runs
        unguarded). Returns the output and the host copies of
        ``reads(out)``."""
        man = self.reliability
        degraded = man is not None and man.degraded
        guard = (self.sanitizer.decode_guard(self.device)
                 if guarded and self.sanitizer is not None else None)
        out, scope = self._dispatch(
            run, man.fallback if degraded else self.params, degraded,
            guard=guard)
        host = self._fetch(reads(out), scope, self._nan_inputs(out))
        if man is None or degraded:
            return out, host
        bad = man.drain()
        if bad:
            man.record_violations(bad)
            with trace.span("engine.replay"):
                t0 = time.perf_counter()
                if restore is not None:
                    restore()
                out, scope = self._dispatch(run, man.fallback, True)
                host = self._fetch(reads(out), scope, self._nan_inputs(out))
                man.note_retry(time.perf_counter() - t0)
            self._after_violation()
        return out, host

    def _run_prefill(self, toks: torch.Tensor, length: int):
        """A whole prefill: its first token (host int) and KV. It builds a
        fresh cache, so a replay needs no restore."""
        out, host = self._checked(
            lambda params, fb: self._prefill_fn(params, toks, length, fb),
            lambda out: [out[0]])
        return int(host[0]), out[1]

    def _run_chunk(self, scratch, toks: torch.Tensor, start: int, li: int,
                   last: bool):
        """One chunk into ``scratch`` in place: its token (a host int for
        the last chunk, else None) and the scratch. A replay needs no
        restore: the chunk writes its positions [start, start + C) before
        it reads them and reads no later position, so a replay on the
        faulty dispatch's scratch computes the fault-free chunk and
        overwrites every entry the faulty one wrote."""
        out, host = self._checked(
            lambda params, fb: self._chunk_fn(params, scratch, toks, start,
                                              li, fb),
            lambda out: [out[0]] if last else [])
        return (int(host[0]) if last else None), out[1]

    @staticmethod
    def _snapshot(cache, pos: torch.Tensor, w: int):
        """What a w-step window may write in place: each slot row's
        positions [pos, pos + w) of every layer's K and V (a frozen row
        rewrites its last one; clamped to the cache), copied. Returns the
        closure that puts them back. Faulty tokens can stop a row early
        or late inside the window, so the replay alone would not
        overwrite every entry the faulty window wrote."""
        cols = (pos[:, None] + torch.arange(w, device=pos.device)[None]
                ).clamp(max=cache["k"].shape[2] - 1)
        rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
        saved = {key: cache[key][:, rows, cols] for key in ("k", "v")}

        def restore():
            for key, blk in saved.items():
                cache[key][:, rows, cols] = blk
        return restore

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _chunk_starts(self, plen: int, tail_from: int = 0) -> List[int]:
        """Chunk-start grid covering positions [tail_from, plen). Starts
        clamp to P - C so the fixed-shape chunk never writes past the
        scratch; a clamped chunk recomputes a deterministic overlap."""
        C, P = self.prefill_chunk, self.prompt_pad
        starts: List[int] = []
        s = tail_from
        while True:
            s_eff = min(s, P - C)
            starts.append(s_eff)
            if s_eff + C >= plen:
                return starts
            s = s_eff + C

    def start_prefill(self, tokens, shared_prefix_len: int = 0,
                      request_id: Hashable = None) -> PrefillTask:
        """Begin a prefill. Returns a task whose remaining work is a
        sequence of ``prefill_step`` calls (exactly one step-function call
        each) — the scheduler interleaves them with decode steps.
        Full-prompt cache hits finish in a single free ``prefill_step``.

        ``shared_prefix_len`` marks a shared-prefix boundary (e.g. the
        system prompt length). It only enables KV reuse when both the
        prefix cache and chunked prefill are on; otherwise it is
        ignored (exact full-prompt caching still applies). ``request_id``
        labels the task's spans."""
        task = PrefillTask(tokens, shared_prefix_len, request_id)
        plen = task.length
        if not (1 <= plen <= self.prompt_pad):
            raise ValueError(f"prompt length {plen} not in "
                             f"[1, {self.prompt_pad}]")
        if self.prefix_cache is not None:
            entry = self.prefix_cache.get(task.key)
            if entry is not None and entry.kind == "full" \
                    and entry.length == plen:
                # exact full-prompt hit: no compute at all; the task
                # finishes on its first (free) prefill_step
                task.prefix = Prefix(length=plen,
                                     first_token=int(entry.first_token),
                                     kv=entry.kv, key=task.key,
                                     from_cache=True)
                return task
        if self.prefill_chunk is None:
            return task
        padded = np.zeros((self.prompt_pad,), np.int32)
        padded[:plen] = task.tokens
        m = min(max(int(shared_prefix_len), 0), plen - 1)
        task.scratch = self._init_scratch()
        if self.prefix_cache is not None and m > 0:
            pkey = token_key(task.tokens[:m])
            entry = self.prefix_cache.get(pkey)
            if entry is not None and entry.length == m:
                # shared-prefix hit: seed a copy of the entry (the tail
                # chunks write the scratch in place), run only the tail
                task.scratch = {"k": entry.kv["k"].clone(),
                                "v": entry.kv["v"].clone()}
                task.phases = [(padded, self._chunk_starts(plen, m))]
                return task
            # miss: phase 0 prefills tokens[:m] alone (pad beyond m, so
            # the snapshot is tail-independent and reusable), phase 1
            # resumes at m with this request's real tail
            prefix_padded = np.zeros((self.prompt_pad,), np.int32)
            prefix_padded[:m] = task.tokens[:m]
            pstarts = [s for s in self._chunk_starts(m) if s < m]
            task.phases = [(prefix_padded, pstarts),
                           (padded, self._chunk_starts(plen, m))]
            task.prefix_key = pkey
            return task
        task.phases = [(padded, self._chunk_starts(plen))]
        return task

    def prefill_step(self, task: PrefillTask) -> bool:
        """Advance ``task`` by one unit of prefill work (at most one
        step-function call). Returns True when the task finished and
        ``task.prefix`` is available."""
        if task.finished:
            return True
        plen = task.length
        if self.prefill_chunk is None:
            padded = np.zeros((1, self.prompt_pad), np.int32)
            padded[0, :plen] = task.tokens
            with trace.span("engine.prefill", request=task.request_id,
                            rows=self.prompt_pad, prompt=plen):
                tok0, kv = self._run_prefill(self._tokens(padded), plen)
            trace.count("engine.prefill_rows", self.prompt_pad)
            trace.count("engine.prompt_tokens", plen)
            task.prefix = Prefix(length=plen, first_token=tok0, kv=kv,
                                 key=task.key)
        else:
            phase, idx = task.cursor
            toks, starts = task.phases[phase]
            start = starts[idx]
            blk = toks[None, start:start + self.prefill_chunk]
            last = (phase == len(task.phases) - 1 and
                    idx == len(starts) - 1)
            li = (plen - 1) - start if last else 0
            with trace.span("engine.prefill_chunk", request=task.request_id,
                            rows=self.prefill_chunk, start=start):
                tok, task.scratch = self._run_chunk(
                    task.scratch, self._tokens(blk), start, li, last)
            trace.count("engine.prefill_rows", self.prefill_chunk)
            if last:
                trace.count("engine.prompt_tokens", plen)
            if idx + 1 < len(starts):
                task.cursor = (phase, idx + 1)
            elif phase + 1 < len(task.phases):
                # phase boundary: snapshot the shared prefix for reuse (a
                # copy: phase 1 writes the scratch in place)
                if task.prefix_key is not None \
                        and self.prefix_cache is not None:
                    self.prefix_cache.put(task.prefix_key, PrefixEntry(
                        kind="prefix", length=task.shared_prefix_len,
                        kv={"k": task.scratch["k"].clone(),
                            "v": task.scratch["v"].clone()}))
                task.cursor = (phase + 1, 0)
            else:
                kv = {"k": task.scratch["k"], "v": task.scratch["v"]}
                task.prefix = Prefix(length=plen, first_token=tok, kv=kv,
                                     key=task.key)
        if task.finished and self.prefix_cache is not None \
                and not task.prefix.from_cache:
            self.prefix_cache.put(task.key, PrefixEntry(
                kind="full", length=plen,
                first_token=task.prefix.first_token, kv=task.prefix.kv))
        return task.finished

    def prefill(self, tokens, shared_prefix_len: int = 0,
                params=None) -> Prefix:
        """Facade verb: run a whole prompt (all chunks) and return its
        :class:`Prefix`. ``params`` defaults to the engine's params (any
        params of the same structure serve)."""
        if params is not None and params is not self.params:
            saved, self.params = self.params, params
            try:
                return self.prefill(tokens, shared_prefix_len)
            finally:
                self.params = saved
        task = self.start_prefill(tokens, shared_prefix_len)
        while not self.prefill_step(task):
            pass
        return task.prefix

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def insert(self, prefix: Prefix, state: DecodeState,
               max_new_tokens: int, request_id: Hashable = None,
               slot: Optional[int] = None
               ) -> Tuple[DecodeState, SlotView]:
        """Claim a slot (or fill a pre-reserved one) and write the Prefix
        KV into its row. The Prefix's first token counts as generation
        index 0; if it is a stop token — or the budget is a single token
        — the request is already complete and the slot is released before
        any decode step runs."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prefix.length + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prefix.length} + max_new_tokens "
                f"{max_new_tokens} exceeds max_len={self.max_len}")
        if slot is None:
            slot = state.alloc.alloc(request_id)
            if slot is None:
                raise RuntimeError("no free slot; call generate() until "
                                   "one retires")
        with trace.span("engine.insert", request=request_id, slot=slot):
            state.cache = self._insert_fn(state.cache, prefix.kv, slot,
                                          prefix.length)
        view = SlotView(request_id=request_id, slot=slot,
                        prompt_len=prefix.length, pos=prefix.length,
                        tokens=[int(prefix.first_token)],
                        max_new_tokens=max_new_tokens)
        reason = self._classify(view.tokens[0])
        if reason is not None or max_new_tokens == 1:
            view.done = True
            view.stop_reason = reason or "budget"
            state.alloc.free(slot)
        else:
            state.slots[slot] = view
        return state, view

    def _classify(self, token: int) -> Optional[str]:
        """Host-side stop classification; membership agrees exactly with
        the on-device ``token_stop_mask`` set."""
        if self.eos_token is not None and token == self.eos_token:
            return "eos"
        if token in self._user_stops:
            return "stop_token"
        return None

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------
    def generate(self, state: DecodeState,
                 max_steps: Optional[int] = None
                 ) -> Tuple[DecodeState, StepResult]:
        """One decode dispatch over every occupied slot. ``max_steps``
        caps the fused window (clamped to ``sync_every``; default: as
        many steps as the engine may fuse). Slots whose sequences finish
        — stop token emitted or budget exhausted — are retired and their
        slots freed before this returns. The window's tokens (and its ABFT
        counts) come to the host in one copy."""
        active = state.slots
        if not active:
            return state, StepResult(events=[], finished=[], steps=0)
        w = self.sync_every if max_steps is None else max(1, min(
            int(max_steps), self.sync_every))
        slots = sorted(active)
        with trace.span("engine.generate", slots=slots, steps=w,
                        requests=[active[k].request_id for k in slots]):
            tok_vec = np.zeros((self.num_slots, 1), np.int64)
            pos_vec = np.zeros((self.num_slots,), np.int64)
            done_vec = np.ones((self.num_slots,), bool)
            left_vec = np.zeros((self.num_slots,), np.int64)
            for slot, view in active.items():
                tok_vec[slot, 0] = view.tokens[-1]
                pos_vec[slot] = view.pos
                done_vec[slot] = False
                left_vec[slot] = view.budget_left
            tok_dev, pos_dev = self._tokens(tok_vec), self._tokens(pos_vec)
            cache = state.cache
            man = self.reliability
            if w > 1:
                with trace.span("engine.place"):
                    done_dev = torch.from_numpy(done_vec).to(self.device)
                left_dev = self._tokens(left_vec)
                restore = (self._snapshot(cache, pos_dev, w)
                           if man is not None and not man.degraded else None)
                out, (toks_seq, valid_seq) = self._checked(
                    lambda params, fb: self._window_fn(
                        params, cache, tok_dev, pos_dev, done_dev, left_dev, w,
                        fb),
                    lambda out: [out[0], out[1]], restore, guarded=True)
                valid_seq = valid_seq.astype(bool)
            else:
                # a replay needs no restore: the step writes each row's one
                # position before it reads it, and reads no later position,
                # so the replay overwrites every entry the faulty step wrote
                out, (nxt,) = self._checked(
                    lambda params, fb: self._decode_fn(params, cache, tok_dev,
                                                       pos_dev, fb),
                    lambda out: [out[0]], guarded=True)
                toks_seq = nxt[None]
                valid_seq = ~done_vec[None]
            state.cache = out[2]
            events: List[TokenEvent] = []
            finished: List[Tuple[SlotView, int]] = []
            for i in range(w):           # step-major: sync_every=1 ordering
                for slot in sorted(active):
                    view = active[slot]
                    if view.done or not valid_seq[i, slot]:
                        continue
                    tok = int(toks_seq[i, slot])
                    view.tokens.append(tok)
                    view.pos += 1
                    events.append(TokenEvent(
                        request_id=view.request_id, slot=slot, token=tok,
                        index=len(view.tokens) - 1, step_offset=i))
                    reason = self._classify(tok)
                    if reason is not None or view.budget_left == 0:
                        view.done = True
                        view.stop_reason = reason or "budget"
                        finished.append((view, i))
            for view, _ in finished:
                del state.slots[view.slot]
                state.alloc.free(view.slot)
            return state, StepResult(events=events, finished=finished, steps=w)
