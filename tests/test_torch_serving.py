"""Continuous batching in the port (``repro_torch.serving``): the
counterparts of ``tests/test_serving.py`` (slot-allocator invariants,
scheduler properties under random traffic, token parity with a static
run on programmed plans, fixed step shapes, the serve entry point's metrics)
and parity with the JAX package's scheduler on the same parameters and
the same ``poisson_trace``: identical token streams, stop reasons and
virtual-clock metrics.

The JAX side runs under ``jax.disable_jit()``: eager and jit disagree in
the last bits (ROADMAP §C), and eager is the op-by-op reference. Tokens
are compared exactly; reduced configs (d_model 32-64, vocab 128) keep
the float logits' top two far apart beside the float32 gap between the
packages.
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from hypo_compat import given, settings, st  # noqa: E402

from repro.configs.base import get_config as j_get_config
from repro.core.pim import PimConfig as JPimConfig
from repro.launch import serve as j_serve
from repro.models import lm as j_lm
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import poisson_trace as j_poisson_trace
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.lm import init_cache, init_lm
from repro_torch.serving import (ContinuousScheduler, Request, SlotAllocator,
                                 TokenCollector, poisson_trace,
                                 static_generate)
from repro_torch.serving.slots import check_slot_compatible


def _small_cfg(arch="qwen2.5-3b", layers=2, d_model=64, vocab=128):
    return get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                    vocab=vocab)


_PARAMS_CACHE = {}
_SCHED_CACHE = {}


def _params():
    cfg = _small_cfg()
    return cfg, _PARAMS_CACHE.setdefault(
        "plain", init_lm(cfg, 0, device="cpu"))


# ---------------------------------------------------------------------------
# slot allocator
# ---------------------------------------------------------------------------
def test_allocator_alloc_free_cycle():
    al = SlotAllocator(3)
    slots = [al.alloc(f"r{i}") for i in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert al.alloc("r3") is None, "exhausted pool must refuse"
    assert al.num_free == 0 and al.num_active == 3
    al.free(slots[1])
    assert al.num_free == 1
    assert al.alloc("r4") == slots[1], "freed slot is immediately reusable"
    for s in (slots[0], slots[1], slots[2]):
        al.free(s)
    assert al.num_active == 0 and al.num_free == 3


def test_allocator_double_free_raises():
    al = SlotAllocator(2)
    s = al.alloc("r0")
    al.free(s)
    with pytest.raises(ValueError):
        al.free(s)
    with pytest.raises(ValueError):
        SlotAllocator(0)


def test_slot_compat_rejects_stateful_archs():
    with pytest.raises(NotImplementedError):
        check_slot_compatible(_small_cfg("mamba2-370m"))
    with pytest.raises(NotImplementedError):
        check_slot_compatible(_small_cfg("hymba-1.5b"))
    with pytest.raises(NotImplementedError):
        check_slot_compatible(_small_cfg("whisper-medium"))
    check_slot_compatible(_small_cfg())  # attention-only passes


def test_init_cache_built_on_init_kv_cache():
    cfg = _small_cfg()
    cache = init_cache(cfg, batch=3, max_len=10)
    layered = attn.init_kv_cache(3, 10, cfg.num_kv_heads, cfg.head_dim,
                                 layers=cfg.num_layers)
    assert cache["k"].shape == layered["k"].shape == (
        cfg.num_layers, 3, 10, cfg.num_kv_heads, cfg.head_dim)
    assert cache["v"].dtype == layered["v"].dtype == torch.bfloat16
    per_layer = attn.init_kv_cache(3, 10, cfg.num_kv_heads, cfg.head_dim)
    assert per_layer["k"].shape == (3, 10, cfg.num_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# scheduler invariants (hypothesis-driven)
# ---------------------------------------------------------------------------
@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_scheduler_invariants_random_traffic(seed):
    """Random arrivals and lengths: every request completes exactly once,
    no slot leaks, and every decoded token equals a straight static-batch
    run of the same request."""
    cfg, params = _params()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 8))
    rate = float(rng.choice([0.0, 0.3, 1.5]))
    reqs = poisson_trace(n=n, rate=rate, prompt_lens=[1, 2, 5, 8, 12],
                         gen_lens=[1, 2, 4, 7], vocab=cfg.vocab_size,
                         seed=seed)
    sched = _SCHED_CACHE.setdefault(
        "plain", ContinuousScheduler(params, cfg, num_slots=2,
                                     prompt_pad=12, max_len=19))
    col = TokenCollector()
    res = sched.run(reqs, callbacks=col)
    assert sorted(c.request_id for c in res.completions) == \
        sorted(r.request_id for r in reqs), "each completes exactly once"
    by_id = res.tokens_by_id()
    for r in reqs:
        got = by_id[r.request_id]
        assert got.shape == (r.max_new_tokens,)
        ref = static_generate(params, cfg, r.tokens, r.max_new_tokens)
        np.testing.assert_array_equal(got, ref)
        assert col.streamed[r.request_id] == got.tolist()


@pytest.mark.parametrize("sync_every", [2, 4])
def test_sync_every_token_equality(sync_every):
    cfg, params = _params()
    reqs = poisson_trace(n=10, rate=0.0, prompt_lens=[2, 5, 8, 12],
                         gen_lens=[1, 3, 8, 13], vocab=cfg.vocab_size,
                         seed=11)
    reqs += poisson_trace(n=4, rate=0.5, prompt_lens=[3, 6],
                          gen_lens=[4, 9], vocab=cfg.vocab_size, seed=12)
    for i, r in enumerate(reqs):
        r.request_id = i
    base = ContinuousScheduler(params, cfg, num_slots=3, prompt_pad=12,
                               max_len=25)
    fused = ContinuousScheduler(params, cfg, num_slots=3, prompt_pad=12,
                                max_len=25, sync_every=sync_every)
    r0, r1 = base.run(reqs), fused.run(reqs)
    t0, t1 = r0.tokens_by_id(), r1.tokens_by_id()
    for rid in t0:
        np.testing.assert_array_equal(t0[rid], t1[rid])
    assert r1.metrics["decode_steps"] == r0.metrics["decode_steps"]
    assert r1.metrics["host_syncs"] < r0.metrics["host_syncs"]
    assert r1.metrics["sync_every"] == sync_every
    for k in r0.metrics:
        if "ttft" in k or "latency" in k:
            assert r0.metrics[k] == r1.metrics[k], k
    assert fused.decode_traces <= 2


def test_sync_every_validation():
    cfg, params = _params()
    with pytest.raises(ValueError, match="sync_every"):
        ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=8,
                            max_len=16, sync_every=0)


def test_scheduler_latency_accounting():
    cfg, params = _params()
    rng = np.random.default_rng(0)
    reqs = [
        Request("early", rng.integers(0, 128, size=(4,)).astype(np.int32),
                max_new_tokens=3, arrival=0.0),
        Request("late", rng.integers(0, 128, size=(4,)).astype(np.int32),
                max_new_tokens=2, arrival=5.0),
    ]
    sched = _SCHED_CACHE.setdefault(
        "plain", ContinuousScheduler(params, cfg, num_slots=2,
                                     prompt_pad=12, max_len=19))
    res = sched.run(reqs)
    by_id = {c.request_id: c for c in res.completions}
    assert by_id["late"].admit_step > 5.0
    for c in res.completions:
        assert c.ttft_steps >= 1.0, "prefill itself costs a step"
        assert c.latency_steps >= c.ttft_steps
    m = res.metrics
    assert m["num_requests"] == 2
    assert m["generated_tokens"] == 5
    assert m["latency_steps_p90"] >= m["latency_steps_p50"] > 0


def test_scheduler_rejects_oversized_and_duplicate_requests():
    cfg, params = _params()
    sched = ContinuousScheduler(params, cfg, num_slots=1, prompt_pad=4,
                                max_len=8)
    toks = np.arange(3, dtype=np.int32)
    with pytest.raises(ValueError, match="prompt length"):
        sched.run([Request("a", np.arange(5, dtype=np.int32), 1)])
    with pytest.raises(ValueError, match="max_len"):
        sched.run([Request("a", toks, 9)])
    with pytest.raises(ValueError, match="duplicate"):
        sched.run([Request("a", toks, 1), Request("a", toks, 1)])
    with pytest.raises(ValueError):
        ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=9,
                            max_len=8)


# ---------------------------------------------------------------------------
# token parity on the engine + fixed step shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("substrate", ["exact-cuda", "exact-torch"])
def test_continuous_token_parity_on_engine(substrate):
    """Continuous decode over programmed plans equals static prefill +
    decode_step over the same plans, bit for bit (on CPU tensors
    ``exact-cuda`` runs its kernel's plain version)."""
    cfg = _small_cfg(layers=1, d_model=32)
    planned = t_serve.plan_params_for_pim(
        init_lm(cfg, 0, device="cpu"),
        PimConfig(weight_bits=4, act_bits=4, substrate=substrate))
    reqs = poisson_trace(n=5, rate=0.8, prompt_lens=[2, 4, 7],
                         gen_lens=[1, 3, 5], vocab=cfg.vocab_size, seed=3)
    res = ContinuousScheduler(planned, cfg, num_slots=2, prompt_pad=8,
                              max_len=13).run(reqs)
    for r in reqs:
        ref = static_generate(planned, cfg, r.tokens, r.max_new_tokens)
        np.testing.assert_array_equal(res.tokens_by_id()[r.request_id], ref)
        # the card's comparison: the slots' shapes, the same tokens
        same = static_generate(planned, cfg, r.tokens, r.max_new_tokens,
                               max_len=13, prompt_pad=8, rows=2)
        np.testing.assert_array_equal(same, ref)


def test_step_functions_compile_once_across_refills():
    """More requests than slots forces refills at heterogeneous lengths;
    prefill and decode each run one step-input shape, across runs."""
    cfg, params = _params()
    sched = ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=12,
                                max_len=19)
    reqs = poisson_trace(n=6, rate=0.0, prompt_lens=[1, 3, 6, 9, 12],
                         gen_lens=[1, 2, 5, 7], vocab=cfg.vocab_size,
                         seed=11)
    res = sched.run(reqs)
    assert res.metrics["prefills"] == 6
    assert res.metrics["prefill_traces"] == 1
    assert res.metrics["decode_traces"] == 1
    sched.run(reqs)
    assert sched.prefill_traces == 1 and sched.decode_traces == 1


# ---------------------------------------------------------------------------
# serve entry point + metrics json
# ---------------------------------------------------------------------------
def test_serve_continuous_entry_point(tmp_path):
    path = tmp_path / "metrics.json"
    res = t_serve.serve_continuous(
        "qwen2.5-3b", num_slots=2, num_requests=4, prompt_len=8, gen=4,
        layers=1, d_model=32, pim=True, pim_substrate="exact-jnp",
        arrival_rate=0.5, seed=0, metrics_json=str(path), device="cpu")
    assert res["mode"] == "continuous"
    assert res["num_requests"] == 4
    assert res["pim_substrate"] == "exact-torch"
    assert res["opima_tokens_per_s"] > 0
    data = json.loads(path.read_text())
    for key in ("tokens_per_s", "ttft_steps_p50", "latency_steps_p99",
                "decode_traces", "requests", "opima_tokens_per_s"):
        assert key in data, f"metrics json missing {key}"
    assert len(data["requests"]) == 4
    assert all(isinstance(r["tokens"], list) for r in data["requests"])


def test_serve_static_metrics_json(tmp_path):
    path = tmp_path / "static.json"
    res = t_serve.serve("qwen2.5-3b", batch=1, prompt_len=6, gen=2,
                        layers=1, d_model=32, metrics_json=str(path),
                        device="cpu")
    data = json.loads(path.read_text())
    assert data["mode"] == "static"
    assert data["generated_tokens"] == 2
    assert data["generated"] == np.asarray(res["generated"]).tolist()


def test_warmup_compiles_once_and_preserves_tokens():
    cfg, params = _params()
    sched = ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=12,
                                max_len=19)
    sched.warmup()
    assert sched.prefill_traces == 1 and sched.decode_traces == 1
    reqs = poisson_trace(n=3, rate=0.5, prompt_lens=[3, 6], gen_lens=[2, 4],
                         vocab=cfg.vocab_size, seed=7)
    res = sched.run(reqs)
    assert res.metrics["prefill_traces"] == 1
    assert res.metrics["decode_traces"] == 1
    for r in reqs:
        ref = static_generate(params, cfg, r.tokens, r.max_new_tokens)
        np.testing.assert_array_equal(res.tokens_by_id()[r.request_id], ref)


def test_trace_file_rejects_malformed_records(tmp_path):
    tf = tmp_path / "bad.json"
    tf.write_text(json.dumps([{"arrival": 0.0, "prompt_len": 3}]))
    with pytest.raises(ValueError, match="missing 'gen'"):
        t_serve.serve_continuous("qwen2.5-3b", layers=1, d_model=32,
                                 trace_file=str(tf), device="cpu")
    tf.write_text(json.dumps([{"arrival": 0.0, "gen": 2}]))
    with pytest.raises(ValueError, match="'tokens' or 'prompt_len'"):
        t_serve.serve_continuous("qwen2.5-3b", layers=1, d_model=32,
                                 trace_file=str(tf), device="cpu")


def test_trace_file_driven_arrivals(tmp_path):
    trace = [{"arrival": 0.0, "prompt_len": 3, "gen": 2},
             {"arrival": 1.5, "tokens": [5, 6, 7, 8], "gen": 1,
              "id": "explicit"}]
    tf = tmp_path / "trace.json"
    tf.write_text(json.dumps(trace))
    res = t_serve.serve_continuous("qwen2.5-3b", num_slots=2, layers=1,
                                   d_model=32, trace_file=str(tf),
                                   device="cpu")
    assert res["num_requests"] == 2
    by_id = {r["id"]: r for r in res["requests"]}
    assert set(by_id) == {0, "explicit"}
    assert by_id["explicit"]["prompt_len"] == 4
    assert len(by_id["explicit"]["tokens"]) == 1


# ---------------------------------------------------------------------------
# deadlines and admission policy
# ---------------------------------------------------------------------------
def test_deadline_retires_without_slot_leak():
    cfg, params = _params()
    reqs = [Request(request_id="a", tokens=np.arange(3, dtype=np.int32),
                    max_new_tokens=10, arrival=0.0, deadline=4.0),
            Request(request_id="b", tokens=np.arange(5, dtype=np.int32),
                    max_new_tokens=6, arrival=0.0),
            Request(request_id="c", tokens=np.arange(4, dtype=np.int32),
                    max_new_tokens=10, arrival=0.0, deadline=0.5)]
    sched = ContinuousScheduler(params, cfg, num_slots=1, prompt_pad=8,
                                max_len=18)
    res = sched.run(reqs)
    by = {c.request_id: c for c in res.completions}
    assert by["a"].stop_reason == "deadline"
    assert 0 < by["a"].tokens.shape[0] < 10
    ref = static_generate(params, cfg, reqs[0].tokens, 10)
    np.testing.assert_array_equal(by["a"].tokens,
                                  ref[:by["a"].tokens.shape[0]])
    assert by["c"].stop_reason == "deadline"
    assert by["c"].tokens.shape[0] == 0
    assert by["b"].stop_reason == "budget"
    assert by["b"].tokens.shape[0] == 6
    assert res.metrics["deadline_expiries"] == 2
    assert res.metrics["stop_reasons"]["deadline"] == 2


def test_deadline_validation():
    cfg, params = _params()
    sched = ContinuousScheduler(params, cfg, num_slots=1, prompt_pad=8,
                                max_len=18)
    bad = [Request(request_id=0, tokens=np.arange(3, dtype=np.int32),
                   max_new_tokens=2, arrival=2.0, deadline=2.0)]
    with pytest.raises(ValueError, match="deadline"):
        sched.run(bad)
    with pytest.raises(ValueError, match="admission_policy"):
        ContinuousScheduler(params, cfg, num_slots=1, prompt_pad=8,
                            max_len=18, admission_policy="lifo")


def test_sjf_admission_improves_short_prompt_ttft():
    cfg, params = _params()

    def mk():
        return [Request(request_id="big",
                        tokens=np.arange(12, dtype=np.int32) % 100,
                        max_new_tokens=2, arrival=0.0),
                Request(request_id="small",
                        tokens=np.arange(2, dtype=np.int32) % 100,
                        max_new_tokens=2, arrival=0.0)]

    ttft, toks = {}, {}
    for pol in ("fifo", "sjf"):
        sched = ContinuousScheduler(params, cfg, num_slots=2,
                                    prompt_pad=12, max_len=16,
                                    prefill_chunk=2, admission_policy=pol)
        res = sched.run(mk())
        ttft[pol] = {c.request_id: c.ttft_steps for c in res.completions}
        toks[pol] = res.tokens_by_id()
        assert res.metrics["admission_policy"] == pol
    assert ttft["sjf"]["small"] < ttft["fifo"]["small"]
    for rid in ("big", "small"):
        np.testing.assert_array_equal(toks["fifo"][rid], toks["sjf"][rid])


# ---------------------------------------------------------------------------
# parity with the JAX package's scheduler
# ---------------------------------------------------------------------------
_JAX_MODELS = {}


def _jax_model(pim):
    """(JAX cfg, JAX params, port cfg, port params): JAX's reduced
    qwen2.5-3b (1 layer, d_model 32), planned on exact-jnp when ``pim``,
    and the same parameters converted."""
    if pim not in _JAX_MODELS:
        jcfg = j_get_config("qwen2.5-3b").reduced(num_layers=1, d_model=32,
                                                  vocab=128)
        jp = j_lm.init_lm(jcfg, jax.random.PRNGKey(0))
        if pim:
            jp = j_serve.plan_params_for_pim(
                jp, JPimConfig(weight_bits=4, act_bits=4,
                               substrate="exact-jnp"))
            tp = convert.planned_params_from_reference(jp, "cpu")
        else:
            tp = convert.params_from_reference(jp, "cpu")
        _JAX_MODELS[pim] = (jcfg, jp, convert.model_config_from_reference(
            jcfg), tp)
    return _JAX_MODELS[pim]


# the metrics computed on the virtual clock (and the step counts): equal
_VIRTUAL = ("num_requests", "num_slots", "prompt_pad", "max_len",
            "prefills", "prefill_units", "prefill_chunk", "decode_steps",
            "sync_every", "host_syncs", "generated_tokens",
            "admission_policy", "stop_reasons", "deadline_expiries",
            "prefix_cache", "mean_slot_occupancy", "ttft_steps_p50",
            "ttft_steps_p90", "ttft_steps_p99", "latency_steps_p50",
            "latency_steps_p90", "latency_steps_p99")


def test_poisson_trace_equals_jax():
    for kw in (dict(n=9, rate=0.7, seed=4),
               dict(n=5, rate=0.0, seed=1, shared_prefix_len=3)):
        args = dict(prompt_lens=[1, 4, 9], gen_lens=[2, 5], vocab=128, **kw)
        for got, want in zip(poisson_trace(**args),
                             j_poisson_trace(**args)):
            assert (got.request_id, got.max_new_tokens, got.arrival,
                    got.shared_prefix_len, got.deadline) == \
                (want.request_id, want.max_new_tokens, want.arrival,
                 want.shared_prefix_len, want.deadline)
            np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("pim,kw", [
    (False, dict(sync_every=3, stop_tokens=(5, 9), eos_token=2)),
    (True, dict(prefill_chunk=4, prefix_cache=8)),
    (True, dict(sync_every=2, admission_policy="sjf", prefill_chunk=5)),
], ids=["float-stops-window", "pim-chunk-prefix", "pim-sjf-window"])
def test_continuous_matches_jax_scheduler(pim, kw):
    """The same trace through both packages' schedulers: identical token
    streams, stop reasons and virtual-clock metrics."""
    jcfg, jp, cfg, tp = _jax_model(pim)
    shared = 3 if "prefix_cache" in kw else 0
    geometry = dict(num_slots=2, prompt_pad=8 + shared, max_len=14 + shared)
    trace = dict(n=6, rate=0.6, prompt_lens=[1, 3, 8], gen_lens=[1, 3, 6],
                 vocab=cfg.vocab_size, seed=17, shared_prefix_len=shared)
    with jax.disable_jit():
        want = JScheduler(jp, jcfg, **geometry, **kw).run(
            j_poisson_trace(**trace))
    got = ContinuousScheduler(tp, cfg, **geometry, **kw).run(
        poisson_trace(**trace))
    wc = {c.request_id: c for c in want.completions}
    assert [c.request_id for c in got.completions] == \
        [c.request_id for c in want.completions]
    for c in got.completions:
        np.testing.assert_array_equal(c.tokens, wc[c.request_id].tokens)
        assert c.stop_reason == wc[c.request_id].stop_reason
        assert (c.arrival_step, c.admit_step, c.finish_step, c.slot) == \
            (wc[c.request_id].arrival_step, wc[c.request_id].admit_step,
             wc[c.request_id].finish_step, wc[c.request_id].slot)
    for key in _VIRTUAL:
        assert got.metrics[key] == want.metrics[key], key
    assert set(got.metrics) == set(want.metrics)


def test_prefill_tensor_logits_index_equals_int():
    """``prefill``'s logits row read with a tensor index (on the device,
    no host sync) equals the int index's, bit for bit."""
    cfg, params = _params()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 9)))
    for j in (0, 4, 8):
        want, _ = lm.prefill(params, cfg, {"tokens": toks}, 12,
                             logits_index=j)
        got, _ = lm.prefill(params, cfg, {"tokens": toks}, 12,
                            logits_index=torch.tensor(j))
        assert torch.equal(got, want)
    last, _ = lm.prefill(params, cfg, {"tokens": toks}, 12)
    assert torch.equal(last, want)


def test_prefill_chunk_rejects_non_attention_archs():
    cfg = _small_cfg("mamba2-370m")
    with pytest.raises(NotImplementedError, match="attention-only"):
        lm.prefill_chunk({}, cfg, {}, torch.zeros((1, 2), dtype=torch.long),
                         0)
