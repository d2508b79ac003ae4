"""Serving-engine facade in the port (``repro_torch.serving.engine``):
the counterparts of ``tests/test_serving_engine.py``.

Covers the four production behaviours the engine adds over the raw
scheduler machinery — content-dependent stopping (EOS / stop tokens
detected on the device), chunked prefill (bit-identical to single-shot at
every chunk size), shared-prefix KV reuse (cache hit == miss, token for
token; cached blocks never alias a scratch that later chunks write in
place), and the masked decode window (fused ragged tails and mid-window
stops) — plus hypothesis invariants (no slot leaks, exactly one
completion per request, nothing emitted after a stop token) and the
serve entry points' stop_reason plumbing in both modes. The JAX file's
mesh-less shard-stamp warning belongs to ROADMAP A11 here
(``tests/test_torch_persist.py`` holds the port's warning).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from hypo_compat import given, settings, st  # noqa: E402

from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.launch import serve as t_serve
from repro_torch.models.lm import init_lm, token_stop_mask
from repro_torch.serving import (ContinuousScheduler, Request, ServingEngine,
                                 poisson_trace, static_generate)


def _small_cfg(arch="qwen2.5-3b", layers=2, d_model=64, vocab=128):
    return get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                    vocab=vocab)


_PARAMS_CACHE = {}


def _params(key="plain", **cfg_kw):
    cfg = _small_cfg(**cfg_kw)
    return cfg, _PARAMS_CACHE.setdefault(key, init_lm(cfg, 0, device="cpu"))


def _truncate_at_stop(tokens: np.ndarray, stop_set) -> np.ndarray:
    """Host reference for content-dependent stopping: cut after the
    first stop token (inclusive — the stop token is emitted)."""
    for j, t in enumerate(tokens.tolist()):
        if t in stop_set:
            return tokens[:j + 1]
    return tokens


def _drain(engine, state, view):
    """Generate until the given view retires; returns its tokens."""
    while not view.done:
        state, _ = engine.generate(state)
    return np.asarray(view.tokens, np.int32)


# ---------------------------------------------------------------------------
# facade basics
# ---------------------------------------------------------------------------
def test_engine_facade_prefill_insert_generate():
    """The three verbs, no slot bookkeeping at the call site: tokens
    equal a static run, and the slot frees itself on retirement."""
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                        max_len=14)
    state = eng.init_state()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(5,)).astype(np.int32)
    prefix = eng.prefill(prompt)
    assert prefix.length == 5 and not prefix.from_cache
    state, view = eng.insert(prefix, state, max_new_tokens=6,
                             request_id="r0")
    assert state.num_free == 1
    got = _drain(eng, state, view)
    assert view.stop_reason == "budget"
    assert state.num_free == 2, "slot returns to the pool on retirement"
    ref = static_generate(params, cfg, prompt, 6)
    np.testing.assert_array_equal(got, ref)


def test_engine_insert_validates_budget_and_len():
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=1, prompt_pad=8,
                        max_len=10)
    state = eng.init_state()
    prefix = eng.prefill(np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.insert(prefix, state, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_len"):
        eng.insert(prefix, state, max_new_tokens=7)
    # budget of one: complete at admission, no decode step
    state, view = eng.insert(prefix, state, max_new_tokens=1)
    assert view.done and view.stop_reason == "budget"
    assert len(view.tokens) == 1 and state.num_free == 1


def test_token_stop_mask_device_semantics():
    stops = torch.tensor([3, 7], dtype=torch.int32)
    toks = torch.tensor([1, 3, 7, 4])
    assert token_stop_mask(toks, stops).tolist() == [False, True, True,
                                                     False]
    empty = torch.zeros((0,), dtype=torch.int32)
    assert not token_stop_mask(toks, empty).any(), \
        "empty stop set means budget-only stopping"
    with pytest.raises(ValueError, match="1-D"):
        token_stop_mask(toks, torch.zeros((1, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# content-dependent stopping
# ---------------------------------------------------------------------------
def _pick_mid_token(seq: np.ndarray):
    """A token that appears strictly before the last position — using it
    as a stop token must truncate the sequence early."""
    for j, t in enumerate(seq.tolist()[:-1]):
        if t not in seq.tolist()[:j]:
            return t, j
    return None, None


def test_stop_token_retires_slot_early():
    """Pick a token the model actually emits mid-sequence; serving with
    it as a stop token must end the request the step it appears, emit
    nothing after it, and classify the reason correctly."""
    cfg, params = _params()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=(6,)).astype(np.int32)
    ref = static_generate(params, cfg, prompt, 10)
    stop_tok, j = _pick_mid_token(ref)
    assert stop_tok is not None, "degenerate reference sequence"
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                        max_len=18, stop_tokens=(stop_tok,))
    state = eng.init_state()
    state, view = eng.insert(eng.prefill(prompt), state,
                             max_new_tokens=10, request_id="r")
    got = _drain(eng, state, view)
    np.testing.assert_array_equal(got, ref[:j + 1])
    assert view.stop_reason == "stop_token"
    # same token as EOS instead: identical truncation, "eos" label wins
    eng2 = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                         max_len=18, eos_token=stop_tok)
    state2 = eng2.init_state()
    state2, view2 = eng2.insert(eng2.prefill(prompt), state2,
                                max_new_tokens=10, request_id="r")
    np.testing.assert_array_equal(_drain(eng2, state2, view2), got)
    assert view2.stop_reason == "eos"


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_stop_invariants_random_traffic(seed):
    """Random traffic with a random stop set and random deadlines:
    every request completes exactly once, no slot leaks (the scheduler
    asserts on drain), no token ever follows a stop token, and a
    deadline-expired request retires with a strict prefix of its
    reference tokens (its slot freed, never hanging the drain loop)."""
    cfg, params = _params()
    rng = np.random.default_rng(seed)
    stop_set = {int(t) for t in
                rng.integers(0, cfg.vocab_size, size=(3,))}
    reqs = poisson_trace(n=int(rng.integers(1, 7)),
                         rate=float(rng.choice([0.0, 0.7])),
                         prompt_lens=[1, 3, 6, 10],
                         gen_lens=[1, 2, 5, 8], vocab=cfg.vocab_size,
                         seed=seed)
    for r in reqs:
        if rng.random() < 0.4:
            r.deadline = r.arrival + float(rng.uniform(0.5, 12.0))
    sched = ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=10,
                                max_len=18,
                                stop_tokens=tuple(sorted(stop_set)))
    res = sched.run(reqs)
    assert sorted(c.request_id for c in res.completions) == \
        sorted(r.request_id for r in reqs)
    by_id = {c.request_id: c for c in res.completions}
    for r in reqs:
        c = by_id[r.request_id]
        ref = _truncate_at_stop(
            static_generate(params, cfg, r.tokens, r.max_new_tokens),
            stop_set)
        if c.stop_reason == "deadline":
            assert r.deadline is not None
            assert c.finish_step >= r.deadline
            n = len(c.tokens)
            assert n < len(ref), "a full sequence must not expire"
            np.testing.assert_array_equal(c.tokens, ref[:n])
            continue
        np.testing.assert_array_equal(c.tokens, ref)
        body, last = c.tokens[:-1].tolist(), int(c.tokens[-1])
        assert not any(t in stop_set for t in body), \
            "no token may follow a stop token"
        if c.stop_reason == "stop_token":
            assert last in stop_set
        else:
            assert c.stop_reason == "budget"
            assert len(c.tokens) == r.max_new_tokens
            assert last not in stop_set
    counts = res.metrics["stop_reasons"]
    assert sum(counts.values()) == len(reqs)


@pytest.mark.parametrize("sync_every", [3])
def test_masked_window_stops_match_single_step(sync_every):
    """Mid-window stops stay inside the fused scan: a stop-token run
    under sync_every > 1 emits exactly the single-step run's tokens,
    with fewer host syncs and still at most two decode traces."""
    cfg, params = _params()
    rng = np.random.default_rng(2)
    stop_set = tuple(int(t) for t in
                     rng.integers(0, cfg.vocab_size, size=(4,)))
    reqs = poisson_trace(n=8, rate=0.0, prompt_lens=[2, 5, 9],
                         gen_lens=[2, 6, 11], vocab=cfg.vocab_size,
                         seed=21)
    kw = dict(num_slots=3, prompt_pad=9, max_len=20, stop_tokens=stop_set)
    base = ContinuousScheduler(params, cfg, **kw)
    fused = ContinuousScheduler(params, cfg, sync_every=sync_every, **kw)
    r0, r1 = base.run(reqs), fused.run(reqs)
    t0, t1 = r0.tokens_by_id(), r1.tokens_by_id()
    for rid in t0:
        np.testing.assert_array_equal(t0[rid], t1[rid])
    assert {c.request_id: c.stop_reason for c in r0.completions} == \
        {c.request_id: c.stop_reason for c in r1.completions}
    assert r1.metrics["host_syncs"] < r0.metrics["host_syncs"]
    assert fused.decode_traces <= 2


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("substrate", ["exact-cuda", "exact-torch"])
def test_chunked_prefill_bit_identity_every_chunk_size(substrate):
    """The load-bearing numerical claim, on exact substrates: chunked
    prefill produces the *bit-identical* first token and KV block of
    single-shot prefill, for every chunk size (1..P) and prompt length —
    including chunk sizes that do not divide the prompt and the clamped
    final chunk. (On float weights a one-row chunk's projections take
    the CPU's matrix-vector path and round differently: ROADMAP §C.)"""
    cfg = _small_cfg(layers=1, d_model=32)
    params = t_serve.plan_params_for_pim(
        init_lm(cfg, 0, device="cpu"), PimConfig(substrate=substrate))
    P = 12
    whole = ServingEngine(params, cfg, num_slots=1, prompt_pad=P,
                          max_len=P + 2, cache_dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = {plen: rng.integers(0, cfg.vocab_size,
                                  size=(plen,)).astype(np.int32)
               for plen in (1, 5, 11, 12)}
    refs = {plen: whole.prefill(p) for plen, p in prompts.items()}
    for C in (1, 2, 3, 4, 5, 7, 12):
        eng = ServingEngine(params, cfg, num_slots=1, prompt_pad=P,
                            max_len=P + 2, cache_dtype=torch.float32,
                            prefill_chunk=C)
        for plen, prompt in prompts.items():
            got = eng.prefill(prompt)
            ref = refs[plen]
            assert got.first_token == ref.first_token, (C, plen)
            for key in ("k", "v"):
                g = got.kv[key].float().numpy()[:, :, :plen]
                r = ref.kv[key].float().numpy()[:, :, :plen]
                np.testing.assert_array_equal(g, r, err_msg=f"{C}/{plen}")


def test_chunked_scheduler_tokens_equal_unchunked():
    """End to end through the scheduler (default bf16 slot cache, mixed
    traffic): chunked prefill changes interleaving only, never tokens."""
    cfg, params = _params()
    reqs = poisson_trace(n=7, rate=0.4, prompt_lens=[1, 4, 8, 12],
                         gen_lens=[2, 5, 9], vocab=cfg.vocab_size,
                         seed=5)
    kw = dict(num_slots=2, prompt_pad=12, max_len=21)
    plain = ContinuousScheduler(params, cfg, **kw).run(reqs)
    for C in (3, 12):
        chunked = ContinuousScheduler(params, cfg, prefill_chunk=C,
                                      **kw).run(reqs)
        t0, t1 = plain.tokens_by_id(), chunked.tokens_by_id()
        for rid in t0:
            np.testing.assert_array_equal(t0[rid], t1[rid], err_msg=f"C={C}")
        assert chunked.metrics["prefill_units"] >= \
            plain.metrics["prefill_units"]
    ref = {r.request_id: static_generate(params, cfg, r.tokens,
                                         r.max_new_tokens) for r in reqs}
    for rid, toks in chunked.tokens_by_id().items():
        np.testing.assert_array_equal(toks, ref[rid])


# ---------------------------------------------------------------------------
# shared-prefix KV reuse
# ---------------------------------------------------------------------------
def test_prefix_cache_full_hit_equals_miss():
    """Exact full-prompt reuse (works without chunking): the second
    prefill of the same prompt is served from cache and decodes to the
    same tokens."""
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                        max_len=14, prefix_cache_capacity=4)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32)
    p0 = eng.prefill(prompt)
    p1 = eng.prefill(prompt)
    assert not p0.from_cache and p1.from_cache
    assert p0.first_token == p1.first_token
    outs = []
    for prefix in (p0, p1):
        state = eng.init_state()
        state, view = eng.insert(prefix, state, max_new_tokens=5,
                                 request_id="r")
        outs.append(_drain(eng, state, view))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0],
                                  static_generate(params, cfg, prompt, 5))
    assert eng.prefix_cache.stats()["hits"] == 1


def test_shared_prefix_hit_equals_miss():
    """Shared-prefix reuse (chunked): requests sharing a prefix but
    differing in tail decode to exactly what an uncached engine
    produces — and the second request's prefill skips the prefix."""
    cfg, params = _params()
    rng = np.random.default_rng(7)
    m = 6
    shared = rng.integers(0, cfg.vocab_size, size=(m,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
             for n in (4, 6)]
    prompts = [np.concatenate([shared, t]) for t in tails]
    kw = dict(num_slots=2, prompt_pad=12, max_len=20, prefill_chunk=4)
    cached = ServingEngine(params, cfg, prefix_cache_capacity=8, **kw)
    plain = ServingEngine(params, cfg, **kw)
    for i, prompt in enumerate(prompts):
        pc = cached.prefill(prompt, shared_prefix_len=m)
        pp = plain.prefill(prompt)
        assert pc.first_token == pp.first_token, i
        sc, sp = cached.init_state(), plain.init_state()
        sc, vc = cached.insert(pc, sc, max_new_tokens=6, request_id=i)
        sp, vp = plain.insert(pp, sp, max_new_tokens=6, request_id=i)
        np.testing.assert_array_equal(_drain(cached, sc, vc),
                                      _drain(plain, sp, vp))
    stats = cached.prefix_cache.stats()
    assert stats["hits"] >= 1, "second request must reuse the prefix KV"


def test_shared_prefix_through_scheduler():
    """Request.shared_prefix_len flows through the scheduler; tokens are
    identical with the cache on and off and the cache reports hits."""
    cfg, params = _params()
    reqs = poisson_trace(n=6, rate=0.5, prompt_lens=[2, 4, 6],
                         gen_lens=[2, 4], vocab=cfg.vocab_size, seed=9,
                         shared_prefix_len=5)
    assert all(r.shared_prefix_len == 5 for r in reqs)
    kw = dict(num_slots=2, prompt_pad=11, max_len=19, prefill_chunk=3)
    r0 = ContinuousScheduler(params, cfg, **kw).run(reqs)
    r1 = ContinuousScheduler(params, cfg, prefix_cache=8, **kw).run(reqs)
    t0, t1 = r0.tokens_by_id(), r1.tokens_by_id()
    for rid in t0:
        np.testing.assert_array_equal(t0[rid], t1[rid])
    assert r1.metrics["prefix_cache"]["hits"] >= 1
    assert r0.metrics["prefix_cache"] is None


def test_prefix_cache_lru_eviction_under_churn():
    """LRU capacity edges: the cache never exceeds capacity, the oldest
    untouched entry is the one evicted, a re-inserted evicted prompt is
    bit-identical to its original miss, and a touched (recently hit)
    entry survives the churn."""
    from repro_torch.serving.prefix import (PrefixCache, PrefixEntry,
                                            token_key)
    cache = PrefixCache(capacity=2)
    with pytest.raises(ValueError):
        PrefixCache(capacity=0)
    keys = [token_key(np.asarray([i, i + 1], np.int32)) for i in range(3)]
    for i, k in enumerate(keys):
        cache.put(k, PrefixEntry(kind="full", length=2, kv={},
                                 first_token=i))
    assert len(cache) == 2, "capacity bound holds under churn"
    assert cache.get(keys[0]) is None, "oldest entry evicted"
    assert cache.get(keys[2]).first_token == 2
    # keys[2] was just touched; inserting a new entry must evict keys[1]
    cache.put(keys[0], PrefixEntry(kind="full", length=2, kv={},
                                   first_token=0))
    assert cache.get(keys[1]) is None
    assert cache.get(keys[2]) is not None

    # through the engine: evict a prompt, re-prefill it (a fresh miss),
    # and the recomputed KV decodes to exactly the original tokens
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                        max_len=14, prefix_cache_capacity=1)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(6,)).astype(np.int32)
               for _ in range(2)]
    outs = {}
    for round_ in range(2):           # round 2 re-prefills evicted prompts
        for i, prompt in enumerate(prompts):
            p = eng.prefill(prompt)
            assert not p.from_cache, "capacity-1 churn evicts everything"
            state = eng.init_state()
            state, view = eng.insert(p, state, max_new_tokens=4,
                                     request_id=(round_, i))
            outs.setdefault(i, []).append(_drain(eng, state, view))
    for i in outs:
        np.testing.assert_array_equal(outs[i][0], outs[i][1])
    assert len(eng.prefix_cache) == 1


def test_prefix_cache_invalidation_blocks_stale_kv():
    """invalidate_all (fired when plans are re-programmed under the
    engine) drops every entry: the next identical prompt recomputes its
    KV instead of reusing a stale one, and the stats record it."""
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=2, prompt_pad=8,
                        max_len=14, prefix_cache_capacity=4)
    prompt = np.arange(5, dtype=np.int32)
    p0 = eng.prefill(prompt)
    assert eng.prefill(prompt).from_cache
    dropped = eng.prefix_cache.invalidate_all()
    assert dropped == 1
    p2 = eng.prefill(prompt)
    assert not p2.from_cache, "no stale KV reuse after invalidation"
    assert p2.first_token == p0.first_token
    stats = eng.prefix_cache.stats()
    assert stats["invalidations"] == 1
    assert stats["entries"] == 1      # the recomputed entry


# ---------------------------------------------------------------------------
# compile-once with every feature on
# ---------------------------------------------------------------------------
def test_compile_once_with_all_features():
    """Stops + chunked prefill + prefix cache + fused windows together:
    each step function still traces exactly once across two runs."""
    cfg, params = _params()
    sched = ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=10,
                                max_len=18, sync_every=3,
                                stop_tokens=(5, 9), eos_token=2,
                                prefill_chunk=4, prefix_cache=8)
    sched.warmup()
    reqs = poisson_trace(n=6, rate=0.3, prompt_lens=[2, 5, 8],
                         gen_lens=[1, 4, 8], vocab=cfg.vocab_size,
                         seed=13, shared_prefix_len=2)
    sched.run(reqs)
    sched.run([Request(r.request_id, r.tokens, r.max_new_tokens,
                       r.arrival, r.shared_prefix_len) for r in reqs])
    assert sched.prefill_traces == 1
    assert sched.engine.insert_traces == 1
    assert sched.decode_traces <= 2


# ---------------------------------------------------------------------------
# serve entry points: stop_reason in metrics json, both modes
# ---------------------------------------------------------------------------
def test_serve_continuous_stop_reason_metrics_json(tmp_path):
    path = tmp_path / "m.json"
    res = t_serve.serve_continuous(
        "qwen2.5-3b", num_slots=2, num_requests=4, prompt_len=8, gen=4,
        layers=1, d_model=32, arrival_rate=0.5, seed=0, sync_every=2,
        prefill_chunk=3, prefix_cache=4, shared_prefix=3, eos_token=7,
        stop_tokens=(3, 11), metrics_json=str(path), device="cpu")
    data = json.loads(path.read_text())
    assert set(data["stop_reasons"]) == {"budget", "eos", "stop_token",
                                         "deadline"}
    assert sum(data["stop_reasons"].values()) == 4
    assert all(r["stop_reason"] in ("budget", "eos", "stop_token")
               for r in data["requests"])
    assert data["prefix_cache"]["capacity"] == 4
    assert data["prefill_chunk"] == 3
    assert res["prefill_traces"] == 1


def test_serve_static_stop_reason_metrics_json(tmp_path):
    path = tmp_path / "s.json"
    res = t_serve.serve("qwen2.5-3b", batch=2, prompt_len=6, gen=4,
                        layers=1, d_model=32, metrics_json=str(path),
                        device="cpu")
    data = json.loads(path.read_text())
    assert data["stop_reasons"] == {"budget": 2, "eos": 0,
                                    "stop_token": 0}
    # now force a stop: use the first generated token of row 0 as EOS
    eos = int(np.asarray(res["generated"])[0, 0])
    res2 = t_serve.serve("qwen2.5-3b", batch=2, prompt_len=6, gen=4,
                         layers=1, d_model=32, metrics_json=str(path),
                         eos_token=eos, device="cpu")
    data2 = json.loads(path.read_text())
    assert data2["row_stop_reasons"][0] == "eos"
    assert data2["emitted"][0] == [eos], \
        "row truncates at its first stop token (inclusive)"
    assert res2["emitted_tokens"] <= res2["generated_tokens"]


# ---------------------------------------------------------------------------
# what the port leaves to later items
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "A11"),
                                     ({"sanitizer": object()}, "A13"),
                                     ({"reliability": object()}, "A9")])
def test_engine_options_of_later_items_raise(kw, item):
    cfg, params = _params()
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(params, cfg, num_slots=1, prompt_pad=4, max_len=8,
                      **kw)


def test_prefix_cache_entries_never_alias_the_scratch():
    """A shared-prefix snapshot is a copy: the tail chunks that write the
    scratch in place leave the cached block as it was, and a hit seeds a
    copy of the entry."""
    cfg, params = _params()
    eng = ServingEngine(params, cfg, num_slots=1, prompt_pad=12,
                        max_len=16, prefill_chunk=4,
                        prefix_cache_capacity=8)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, size=(4,)).astype(np.int32)
    first = eng.prefill(np.concatenate([shared, [1, 2, 3, 4, 5]]),
                        shared_prefix_len=4)
    entry = next(e for e in eng.prefix_cache._entries.values()
                 if e.kind == "prefix")
    snapshot = {k: v.clone() for k, v in entry.kv.items()}
    assert entry.kv["k"].data_ptr() != first.kv["k"].data_ptr()
    second = eng.prefill(np.concatenate([shared, [9, 8, 7]]),
                         shared_prefix_len=4)
    assert eng.prefix_cache.stats()["hits"] == 1
    assert second.kv["k"].data_ptr() != entry.kv["k"].data_ptr()
    for k in ("k", "v"):
        assert torch.equal(entry.kv[k], snapshot[k])
