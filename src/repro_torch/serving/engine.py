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

The port runs its step functions eagerly, so nothing is compiled:
``prefill_traces`` / ``decode_traces`` / ``insert_traces`` count the
distinct step-input shape signatures run (prefill and chunk calls,
single steps and windows, inserts), the counterpart of the JAX engine's
compile-once counters; on fixed slot geometry each stays 1 (decode, 2
with windows). Out of scope, and raising: ``mesh=`` (ROADMAP A11),
``sanitizer=`` (A13) and ``reliability=`` (A9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
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

    def __init__(self, tokens: np.ndarray, shared_prefix_len: int = 0):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.length = int(self.tokens.shape[0])
        self.shared_prefix_len = shared_prefix_len
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


def _not_ported(mesh, sanitizer, reliability) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "ServingEngine(mesh=): sharded serving is not ported yet "
            "(ROADMAP A11)")
    if sanitizer is not None:
        raise NotImplementedError(
            "ServingEngine(sanitizer=): the runtime sanitizers are not "
            "ported yet (ROADMAP A13)")
    if reliability is not None:
        raise NotImplementedError(
            "ServingEngine(reliability=): ABFT-verified serving and the "
            "degradation machine are not ported yet (ROADMAP A9)")


class ServingEngine:
    """The serving facade. One instance binds params + config + slot
    geometry and owns every step function; traffic lives in
    :class:`DecodeState` objects created by :meth:`init_state`. The
    params' device is the engine's."""

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 prompt_pad: int, max_len: int,
                 cache_dtype=torch.bfloat16, sync_every: int = 1,
                 stop_tokens: Sequence[int] = (),
                 eos_token: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_capacity: int = 0,
                 mesh=None, sanitizer=None, reliability=None):
        _not_ported(mesh, sanitizer, reliability)
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
        self._signatures: Dict[str, set] = {"prefill": set(),
                                            "insert": set(),
                                            "decode": set()}

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

    def _note(self, kind: str, *shapes) -> None:
        self._signatures[kind].add(tuple(tuple(s) for s in shapes))

    # ------------------------------------------------------------------
    # step functions
    # ------------------------------------------------------------------
    def _prefill_fn(self, toks: torch.Tensor, length: int):
        self._note("prefill", toks.shape)
        logits, pcache = lm.prefill(
            self.params, self.cfg, {"tokens": toks}, max_len=self.prompt_pad,
            cache_dtype=self.cache_dtype, logits_index=length - 1)
        tok0 = torch.argmax(logits, -1)[0]
        return tok0, {"k": pcache["k"], "v": pcache["v"]}

    def _chunk_fn(self, scratch, toks: torch.Tensor, start: int, li: int):
        """One chunk into ``scratch``, written in place."""
        self._note("prefill", toks.shape, scratch["k"].shape)
        logits, scratch = lm.prefill_chunk(self.params, self.cfg, scratch,
                                           toks, start, logits_index=li)
        return torch.argmax(logits, -1)[0], scratch

    def _insert_fn(self, cache, kv, slot: int, length: int):
        self._note("insert", kv["k"].shape, cache["k"].shape)
        return slots_mod.write_prefill(cache, kv, slot, length)

    def _decode_fn(self, cache, toks, pos):
        self._note("decode", toks.shape, pos.shape)
        logits, cache = lm.decode_step(self.params, self.cfg, cache, toks,
                                       pos)
        nxt = torch.argmax(logits, -1)
        return nxt, lm.token_stop_mask(nxt, self._stop_arr), cache

    def _window_fn(self, cache, toks, pos, done, left, window_len: int):
        """``window_len`` fused decode steps (sync_every > 1) between host
        syncs. Step i only advances rows that are not done (budget and
        stop tokens flip ``done`` on the device the step they are
        reached); frozen rows recompute their previous step verbatim
        (same token, same position -> bit-identical KV rewrite), so
        nothing after a stop token is ever marked valid."""
        self._note("decode", toks.shape, pos.shape, done.shape, left.shape)
        toks_seq, valid_seq = [], []
        for _ in range(window_len):
            logits, cache = lm.decode_step(self.params, self.cfg, cache,
                                           toks, pos)
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
        return torch.from_numpy(np.asarray(arr, np.int64)).to(self.device)

    def warmup(self) -> None:
        """Run every step function this engine will use once, outside any
        timed window, against throwaway buffers (first-call costs: the
        kernels' libraries, cuBLAS handles, the caching allocator)."""
        cache = self.init_state().cache
        if self.prefill_chunk is not None:
            tok0, kv = self._chunk_fn(
                self._init_scratch(),
                self._tokens(np.zeros((1, self.prefill_chunk))), 0, 0)
        else:
            tok0, kv = self._prefill_fn(
                self._tokens(np.zeros((1, self.prompt_pad))), 1)
        cache = self._insert_fn(cache, kv, 0, 1)
        tok_vec = self._tokens(np.zeros((self.num_slots, 1)))
        pos_vec = self._tokens(np.zeros((self.num_slots,)))
        nxt, _, cache = self._decode_fn(cache, tok_vec, pos_vec)
        if self.sync_every > 1:
            done = torch.zeros((self.num_slots,), dtype=torch.bool,
                               device=self.device)
            left = self._tokens(np.full((self.num_slots,),
                                        self.sync_every))
            toks_seq, _, cache = self._window_fn(cache, tok_vec, pos_vec,
                                                 done, left,
                                                 self.sync_every)
            toks_seq.cpu()
        tok0.cpu(), nxt.cpu()

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

    def start_prefill(self, tokens, shared_prefix_len: int = 0
                      ) -> PrefillTask:
        """Begin a prefill. Returns a task whose remaining work is a
        sequence of ``prefill_step`` calls (exactly one step-function call
        each) — the scheduler interleaves them with decode steps.
        Full-prompt cache hits finish in a single free ``prefill_step``.

        ``shared_prefix_len`` marks a shared-prefix boundary (e.g. the
        system prompt length). It only enables KV reuse when both the
        prefix cache and chunked prefill are on; otherwise it is
        ignored (exact full-prompt caching still applies)."""
        task = PrefillTask(tokens, shared_prefix_len)
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
            tok0, kv = self._prefill_fn(self._tokens(padded), plen)
            task.prefix = Prefix(length=plen, first_token=int(tok0),
                                 kv=kv, key=task.key)
        else:
            phase, idx = task.cursor
            toks, starts = task.phases[phase]
            start = starts[idx]
            blk = toks[None, start:start + self.prefill_chunk]
            last = (phase == len(task.phases) - 1 and
                    idx == len(starts) - 1)
            li = (plen - 1) - start if last else 0
            tok, task.scratch = self._chunk_fn(
                task.scratch, self._tokens(blk), start, li)
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
                task.prefix = Prefix(length=plen, first_token=int(tok),
                                     kv=kv, key=task.key)
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
        slots freed before this returns. The window's tokens come to the
        host in one copy."""
        active = state.slots
        if not active:
            return state, StepResult(events=[], finished=[], steps=0)
        w = self.sync_every if max_steps is None else max(1, min(
            int(max_steps), self.sync_every))
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
        if w > 1:
            toks_dev, valid_dev, state.cache = self._window_fn(
                state.cache, tok_dev, pos_dev,
                torch.from_numpy(done_vec).to(self.device),
                self._tokens(left_vec), w)
            toks_seq = toks_dev.cpu().numpy()
            valid_seq = valid_dev.cpu().numpy()
        else:
            nxt_dev, _, state.cache = self._decode_fn(state.cache, tok_dev,
                                                      pos_dev)
            toks_seq = nxt_dev.cpu().numpy()[None]
            valid_seq = ~done_vec[None]
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
