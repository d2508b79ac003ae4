"""ABFT-verified serving in the port: the serving engine and scheduler
with a :class:`~repro_torch.reliability.ReliabilityManager`, and serve's
reliability options, on the CPU (``exact-torch`` plans; ``exact-cuda``,
the fallback, takes its plain version on CPU tensors).

An armed scheduler under injected faults serves token streams
bit-identical to the port's own fault-free run (the property of
``tests/test_reliability.py``'s serving test, three examples, plus a
fused window whose faulty tokens stop a row at another step than the
fault-free run: the replay starts from the restored pre-dispatch cache,
which must then equal the fault-free cache bit for bit). The counts of a
dispatch reach the fault log once, in the dispatch's own host copy: no
eager record (a sync) per verified matmul. JAX's scheduler is not run
here: ``tests/test_reliability.py`` covers its side, and the metrics'
``reliability`` key set is held to JAX's manager's."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from hypo_compat import given, settings, st  # noqa: E402

from repro.reliability import ReliabilityManager as JManager
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.launch import serve as t_serve
from repro_torch.models.lm import init_lm
from repro_torch.reliability import (FAULT_LOG, FaultModel,
                                     ReliabilityManager, ReliabilityPolicy,
                                     abft, dump_fault_spec)
from repro_torch.reliability.degrade import armed_tags
from repro_torch.serving import (ContinuousScheduler, ServingEngine,
                                 poisson_trace)

_CACHE = {}


@pytest.fixture(autouse=True)
def _clean_fault_log():
    FAULT_LOG.clear()
    yield
    FAULT_LOG.clear()


def _planned(verify="always"):
    """qwen2.5-3b at 2 layers, d_model 64, vocab 128, planned on
    exact-torch with ABFT on (each plan tagged with its layer stack's
    path)."""
    if verify not in _CACHE:
        cfg = get_config("qwen2.5-3b").reduced(num_layers=2, d_model=64,
                                               vocab=128)
        params = _CACHE.setdefault("params", init_lm(cfg, 0, device="cpu"))
        _CACHE[verify] = cfg, t_serve.plan_params_for_pim(
            params, PimConfig(substrate="exact-torch", verify=verify))
    return _CACHE[verify]


def _golden(reqs, **kw):
    cfg, planned = _planned()
    sched = ContinuousScheduler(planned, cfg, **kw)
    return sched.run(reqs).tokens_by_id()


def _assert_same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=str(rid))


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10_000))
def test_served_tokens_survive_random_faults(seed):
    """Property over random fault specs: detection, replay on the golden
    fallback, nothing hangs, tokens equal the fault-free run's."""
    cfg, planned = _planned()
    reqs = poisson_trace(n=4, rate=0.7, prompt_lens=[2, 5, 8],
                         gen_lens=[2, 4], vocab=cfg.vocab_size, seed=seed)
    geo = dict(num_slots=2, prompt_pad=10, max_len=16)
    golden = _golden(reqs, **geo)
    FAULT_LOG.clear()
    rng = np.random.default_rng(seed)
    model = FaultModel(
        target=str(rng.choice(["*", "*wq*", "*mlp*"])), seed=seed,
        bitflips=int(rng.integers(1, 3)),
        stuck_planes=int(rng.integers(0, 2)), stuck_value=15,
        adc_gain=float(rng.choice([1.0, 1.1])))
    man = ReliabilityManager(planned, [model],
                             ReliabilityPolicy(repair_after=2,
                                               degrade_after=2))
    sched = ContinuousScheduler(planned, cfg, reliability=man, **geo)
    _assert_same_tokens(sched.run(reqs).tokens_by_id(), golden)
    detectable = sum(e.get("store_delta") or 0
                     for e in man.injection_report)
    if detectable or any(e["kind"] == "adc_drift"
                         for e in man.injection_report):
        assert man.detections > 0, \
            f"injected faults undetected: {man.injection_report}"
        assert man.retries > 0


def _engine(params, cfg, **kw):
    return ServingEngine(params, cfg, num_slots=2, prompt_pad=8, max_len=20,
                         **kw)


@pytest.mark.parametrize("sync_every", [1, 4])
def test_replay_restores_the_pre_dispatch_cache(sync_every):
    """A fault trips in a decode step or a fused window whose faulty
    tokens stop a row at another step than the fault-free tokens (the
    stop token is the fault-free run's second token): after every
    ``generate`` the armed engine's tokens and whole slot cache equal
    the fault-free engine's, bit for bit."""
    cfg, planned = _planned()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 7)]
    probe = _engine(planned, cfg)
    state = probe.init_state()
    state, view = probe.insert(probe.prefill(prompts[0]), state,
                               max_new_tokens=9)
    while not view.done:
        state, _ = probe.generate(state)
    stop = int(view.tokens[2])
    spec = [FaultModel(target="layers/mlp/wo_hd", seed=5, stuck_planes=2,
                       stuck_value=15, sticky=False)]
    man = ReliabilityManager(planned, spec,
                             ReliabilityPolicy(repair_after=99))

    def serve(eng):
        state = eng.init_state()
        caches, streams = [], []
        views = [eng.insert(eng.prefill(p), state, max_new_tokens=9)[1]
                 for p in prompts]
        while state.slots:
            state, res = eng.generate(state)
            caches.append({k: v.clone() for k, v in state.cache.items()})
            streams.append([(e.slot, e.token) for e in res.events])
        return caches, streams, [v.tokens for v in views]

    kw = dict(sync_every=sync_every, stop_tokens=(stop,))
    want = serve(_engine(planned, cfg, **kw))
    faulty = serve(_engine(man.params, cfg, **kw))
    assert faulty[1] != want[1], "the faults must change the tokens"
    got = serve(_engine(planned, cfg, reliability=man, **kw))
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        for k in ("k", "v"):
            assert torch.equal(g[k], w[k]), k
    assert man.retries >= len(want[0]) and man.repairs == 0


def test_one_delivery_per_dispatch(monkeypatch):
    """Every verified matmul of a dispatch reports into its collect
    scope: the counts come to the host once per dispatch (one
    ``deliver``), never as an eager record (a sync per matmul); the
    checks equal the verified dispatches times the armed tags."""
    cfg, planned = _planned()
    calls = []
    real = abft.deliver
    monkeypatch.setattr(abft, "deliver", lambda names, counts: (
        calls.append((tuple(names), np.asarray(counts).copy())),
        real(names, counts))[1])

    def no_eager(*a, **k):
        raise AssertionError("an eager record inside a dispatch")
    monkeypatch.setattr(FAULT_LOG, "record", no_eager)
    man = ReliabilityManager(planned)
    tags = armed_tags(planned)
    sched = ContinuousScheduler(planned, cfg, num_slots=2, prompt_pad=10,
                                max_len=20, sync_every=3, prefill_chunk=4,
                                reliability=man)
    sched.warmup()
    warm = len(calls)
    assert warm == 3 and all(names == tuple(tags) for names, _ in calls)
    reqs = poisson_trace(n=5, rate=0.8, prompt_lens=[3, 6, 9],
                         gen_lens=[3, 6], vocab=cfg.vocab_size, seed=2)
    m = sched.run(reqs).metrics
    assert len(calls) - warm == m["prefill_units"] + m["host_syncs"]
    assert all(c.shape == (len(tags),) and not c.any() for _, c in calls)
    rel = m["reliability"]
    assert rel["checks"] == (len(calls) - warm + 1) * len(tags)
    assert rel["violations"] == rel["detections"] == rel["retries"] == 0
    assert m["fallback_traces"] == 3


def test_chunked_prefill_prefix_cache_and_repairs():
    """Chunked prefill with a shared-prefix cache under faults: tokens
    equal the fault-free run; each repair flushes the prefix cache, so
    no block computed before it is served after it."""
    cfg, planned = _planned()
    reqs = poisson_trace(n=6, rate=1.0, prompt_lens=[3, 6],
                         gen_lens=[2, 3], vocab=cfg.vocab_size, seed=4,
                         shared_prefix_len=4)
    geo = dict(num_slots=2, prompt_pad=10, max_len=14, prefill_chunk=3,
               prefix_cache=8)
    golden = _golden(reqs, **geo)
    man = ReliabilityManager(
        planned, [FaultModel(target="*wq*", seed=1, bitflips=2,
                             sticky=False)],
        ReliabilityPolicy(repair_after=1, degrade_after=99))
    sched = ContinuousScheduler(planned, cfg, reliability=man, **geo)
    run = sched.run(reqs)
    _assert_same_tokens(run.tokens_by_id(), golden)
    assert man.repairs == 1 and man.detections == 1
    assert run.metrics["prefix_cache"]["hits"] > 0
    assert sched.engine.params is man.params


def test_degraded_engine_serves_the_fallback():
    """A sticky fault exhausts its repairs: the engine pins itself to
    the golden exact fallback (verify off, nothing more to check) and
    the tokens still equal the fault-free run."""
    cfg, planned = _planned()
    reqs = poisson_trace(n=4, rate=0.9, prompt_lens=[4, 8], gen_lens=[4],
                         vocab=cfg.vocab_size, seed=6)
    geo = dict(num_slots=2, prompt_pad=8, max_len=12, sync_every=2)
    golden = _golden(reqs, **geo)
    man = ReliabilityManager(
        planned, [FaultModel(target="layers/attn/*", seed=3,
                             dropped_chunks=1)],
        ReliabilityPolicy(repair_after=1, degrade_after=1))
    sched = ContinuousScheduler(planned, cfg, reliability=man, **geo)
    m = sched.run(reqs).metrics
    _assert_same_tokens(sched.run(reqs).tokens_by_id(), golden)
    assert man.degraded and m["reliability"]["degraded"]
    assert m["reliability"]["detections"] == 1
    assert armed_tags(man.serving_params()) == []
    assert m["fallback_traces"] == 3


def test_reliability_metrics_keys_equal_jax(tmp_path):
    """``--metrics-json`` carries the JAX package's reliability key set,
    and JAX's fault-spec, injection-report and chaos-check fields."""
    spec = tmp_path / "faults.json"
    spec.write_text(dump_fault_spec([FaultModel(
        target="layers/attn/wo_hd", seed=4, adc_gain=1.1)]))
    path = tmp_path / "m.json"
    res = t_serve.serve_continuous(
        "qwen3-4b", device="cpu", layers=1, d_model=32, num_slots=2,
        num_requests=3, prompt_len=8, gen=3, pim=True, abft="sample",
        inject_faults=str(spec), chaos_check=True, metrics_json=str(path))
    data = json.loads(path.read_text())
    want = JManager({}).metrics()
    assert set(data["reliability"]) == set(want)
    assert set(data["reliability"]["recovery_latency_s"]) == \
        set(want["recovery_latency_s"])
    assert data["fault_spec"] == str(spec)
    assert data["injection_report"] == res["injection_report"]
    assert [e["kind"] for e in data["injection_report"]] == ["adc_drift"]
    assert data["chaos_check"] == {"token_mismatches": 0,
                                   "detectable_faults": 0,
                                   "detections": data["reliability"][
                                       "detections"]}
    assert data["reliability"]["detections"] > 0
    assert data["fallback_traces"] == 2


def test_sample_mode_serves_clean_and_chaos_check_fails_loudly(
        monkeypatch):
    """``abft="sample"`` on clean plans: no violation. A chaos check
    whose injected run diverges raises instead of passing."""
    cfg, planned = _planned("sample")
    reqs = poisson_trace(n=3, rate=1.0, prompt_lens=[4], gen_lens=[3],
                         vocab=cfg.vocab_size, seed=1)
    man = ReliabilityManager(planned)
    sched = ContinuousScheduler(planned, cfg, num_slots=2, prompt_pad=4,
                                max_len=8, reliability=man)
    sched.warmup()
    run = sched.run(reqs)
    rel = run.metrics["reliability"]
    assert rel["checks"] > 0 and rel["violations"] == 0
    golden = {k: v + 1 for k, v in run.tokens_by_id().items()}
    with pytest.raises(AssertionError, match="diverged"):
        t_serve.chaos_verdict(golden, run, man)
