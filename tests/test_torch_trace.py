"""The port's in-process spans and counters (``repro_torch.analysis.trace``)
on the CPU: nothing recorded unarmed, parents that follow nesting, one
request id across a request's spans, fine spans and B1's launches kept as
aggregates keyed by the operands' shapes, every span name a CPU range
under ``torch.profiler``, the decode dispatch's three parts, the
scheduler's counters against its own metrics, the compile counter as a
reader of the recorder, and serve's ``--metrics-json`` trace section."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import trace
from repro_torch.analysis.sanitize import CompileCounter, record_compile
from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import ConvSpec, DenseSpec
from repro_torch.kernels.pim_matmul import ops as pim_ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import cnn, lm
from repro_torch.reliability import (FAULT_LOG, FaultModel,
                                     ReliabilityManager, ReliabilityPolicy)
from repro_torch.serving import (ContinuousScheduler, ServingEngine,
                                 poisson_trace)

# the program's spans (coarse and fine) and counters
COARSE = ("sched.iteration", "sched.admit", "engine.prefill",
          "engine.prefill_chunk", "engine.insert", "engine.generate",
          "engine.place", "engine.step", "engine.fetch", "engine.replay",
          "cnn.forward")
FINE = ("pim.quantize", "pim.nibbles", "pim.pad", "attn.prompt",
        "b1.launch")
COUNTERS = ("engine.prefill_rows", "engine.prompt_tokens",
            "sched.decode_steps", "sched.occupied_slot_steps")

_CACHE = {}


@pytest.fixture(autouse=True)
def _nothing_else_armed():
    """Each test starts with no recorder armed (a process may hold one
    armed for its whole run), and leaves the process as it found it."""
    armed = trace._ARMED
    for r in reversed(armed):
        r.__exit__(None, None, None)
    yield
    for r in armed:
        r.__enter__()


def _planned(verify="off"):
    """A reduced qwen3 (2 layers, d_model 64, vocab 128) planned on
    exact-cuda (its plain version on CPU tensors)."""
    if verify not in _CACHE:
        cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=64,
                                             vocab=128)
        params = _CACHE.setdefault("params", lm.init_lm(cfg, 0,
                                                        device="cpu"))
        _CACHE[verify] = cfg, t_serve.plan_params_for_pim(
            params, PimConfig(substrate="exact-cuda", verify=verify))
    return _CACHE[verify]


def _requests(cfg, n=5, seed=3):
    return poisson_trace(n=n, rate=0.0, prompt_lens=[2, 5, 8],
                         gen_lens=[2, 4], vocab=cfg.vocab_size, seed=seed)


def _served(**geo):
    """A recorder over one tiny scheduler run (warm-up outside it), and
    the run's result."""
    cfg, params = _planned()
    sched = ContinuousScheduler(params, cfg, num_slots=2, prompt_pad=8,
                                max_len=16, **geo)
    sched.warmup()
    with trace.Recorder() as rec:
        res = sched.run(_requests(cfg))
    return rec, res


def _tiny_cnn_forward():
    layers = [ConvSpec("stem", 8, 8, 3, 8, 3, 3),
              DenseSpec("fc", 8, 10)]
    params = cnn.init_cnn(layers, torch.Generator().manual_seed(0),
                          device="cpu")
    pim = PimConfig(substrate="exact-cuda")
    plans = cnn.plan_cnn_weights(params, layers, pim)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    return cnn.cnn_forward(params, layers, x, pim=pim, plans=plans)


def _replayed():
    """An ABFT-verified engine whose MLP output plans hold stuck planes:
    a prefill and a decode step, each tripping and replayed. Returns the
    manager."""
    cfg, planned = _planned("always")
    man = ReliabilityManager(planned, [FaultModel(
        target="layers/mlp/wo_hd", seed=5, stuck_planes=2, stuck_value=15,
        sticky=False)], ReliabilityPolicy(repair_after=99))
    eng = ServingEngine(planned, cfg, num_slots=2, prompt_pad=8, max_len=16,
                        reliability=man)
    state = eng.init_state()
    state, _ = eng.insert(eng.prefill(np.arange(5) % cfg.vocab_size),
                          state, max_new_tokens=4, request_id="r0")
    eng.generate(state)
    return man


def test_unarmed_records_nothing():
    assert trace.span("engine.generate") is trace.span("engine.generate")
    assert trace.span("engine.step", steps=1) is trace.fine("b1.launch")
    idle = trace.Recorder()                 # made, never armed
    _tiny_cnn_forward()
    trace.count("sched.decode_steps", 3)
    assert idle.records == [] and idle.fine == {} and idle.counters == {}
    with trace.Recorder() as rec:
        pass
    _tiny_cnn_forward()
    assert rec.records == [] and rec.fine == {} and rec.counters == {}


def test_parents_follow_nesting_per_thread():
    seen = {}

    def other():
        with trace.span("t.other") as s:
            seen["other"] = s.id

    with trace.Recorder() as rec:
        with trace.span("t.outer") as outer:
            with trace.span("t.inner", k=1) as inner:
                inner.set(late=2)
                # a span on another thread does not nest in this one's
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
            with trace.span("t.second"):
                pass
    by = {r.name: r for r in rec.records}
    assert by["t.outer"].parent is None
    assert by["t.inner"].parent == by["t.second"].parent == outer.id
    assert by["t.inner"].attrs == {"k": 1, "late": 2}
    assert by["t.other"].parent is None
    assert by["t.other"].id == seen["other"]
    assert by["t.other"].thread != by["t.outer"].thread
    # children are inside their parent, in order
    inner, second = by["t.inner"], by["t.second"]
    assert by["t.outer"].start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= by["t.outer"].end_ns


def test_self_time_is_the_duration_less_the_children():
    with trace.Recorder() as rec:
        with trace.span("t.parent"):
            time.sleep(0.01)
            with trace.span("t.child"):
                time.sleep(0.02)
            with trace.fine("t.leaf"):
                time.sleep(0.01)
    parent, = rec.spans("t.parent")
    child, = rec.spans("t.child")
    (_, leaf_ns), = rec.aggregate("t.leaf").values()
    assert parent.child_ns == child.ns + leaf_ns
    got = rec.summary()["spans"]
    assert got["t.parent"]["self_ms"] == pytest.approx(
        (parent.ns - child.ns - leaf_ns) / 1e6)
    assert got["t.parent"]["self_ms"] >= 9.0
    assert got["t.leaf"]["self_ms"] == got["t.leaf"]["total_ms"]


def test_a_decorator_span_asks_at_each_call():
    @trace.span("t.decorated")
    def f(x):
        return x + 1

    assert f(1) == 2                         # unarmed: nothing
    with trace.Recorder() as rec:
        assert f(2) == 3 and f(3) == 4
    assert [r.name for r in rec.records] == ["t.decorated"] * 2
    with pytest.raises(TypeError, match="attributes"):
        trace.span("t.decorated", k=1)(f)


def test_a_requests_spans_share_its_id():
    rec, res = _served()
    admits = {r.id: r for r in rec.spans("sched.admit")}
    prefills = rec.spans("engine.prefill")
    inserts = rec.spans("engine.insert")
    assert len(prefills) == len(inserts) == len(res.completions) == 5
    for r in prefills + inserts:
        parent = admits[r.parent]
        assert r.attrs["request"] == parent.attrs["request"]
    assert {r.attrs["request"] for r in prefills} == \
        {c.request_id for c in res.completions}
    slot_of = {c.request_id: c.slot for c in res.completions}
    for r in inserts:
        assert r.attrs["slot"] == slot_of[r.attrs["request"]]
    iterations = {r.id for r in rec.spans("sched.iteration")}
    assert all(a.parent in iterations for a in admits.values())
    for g in rec.spans("engine.generate"):
        assert g.parent in iterations
        assert len(g.attrs["slots"]) == len(g.attrs["requests"]) >= 1


@pytest.mark.parametrize("shape", [(1, 1, 3, 64, 32), (2, 1, 8, 96, 48),
                                   (1, 2, 5, 32, 16)])
def test_fine_spans_aggregate_and_b1_keys_are_the_operand_shapes(shape):
    pa, pw, m, k, n = shape
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-7, 8, (pa, m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-7, 8, (pw, k, n), generator=gen, dtype=torch.int8)
    a_scale = torch.rand((m, 1), generator=gen)
    w_scale = torch.rand((1, n), generator=gen)
    bias = torch.rand((1, n), generator=gen)
    with trace.Recorder() as rec:
        for _ in range(3):
            pim_ops.pim_matmul_fused(a, w, a_scale, w_scale)
        pim_ops.pim_matmul_fused(a, w, a_scale, w_scale, bias=bias,
                                 want_rowsum=True)
    launches = rec.aggregate("b1.launch")
    assert set(launches) == {("plain", pa, pw, m, k, n, False, False),
                             ("plain", pa, pw, m, k, n, True, True)}
    assert launches[("plain", pa, pw, m, k, n, False, False)][0] == 3
    assert launches[("plain", pa, pw, m, k, n, True, True)][0] == 1
    assert rec.records == []                # fine spans keep no records
    assert rec.summary()["spans"]["b1.launch"]["count"] == 4


def test_every_span_name_is_a_cpu_range_under_the_profiler():
    with trace.Recorder() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _served()
            _served(prefill_chunk=4)
            _tiny_cnn_forward()
            man = _replayed()
    FAULT_LOG.clear()
    assert man.retries > 0
    ranges = {e.name for e in prof.events()}
    recorded = {r.name for r in rec.records} | {n for n, _ in rec.fine}
    for name in COARSE + FINE:
        assert name in recorded, name
        assert name in ranges, name


def test_profiler_ranges_one_for_one_with_the_spans():
    with trace.Recorder() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _tiny_cnn_forward()
    events = [e for e in prof.events() if e.name in COARSE + FINE]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    assert by_name["cnn.forward"] == len(rec.spans("cnn.forward")) == 1
    for name in ("pim.quantize", "pim.nibbles", "pim.pad", "b1.launch"):
        assert by_name[name] == sum(
            c for c, _ in rec.aggregate(name).values()) == 2


@pytest.mark.parametrize("geo", [{}, {"sync_every": 2}],
                         ids=["decode", "window"])
def test_every_dispatch_has_its_three_parts(geo):
    rec, _ = _served(**geo)
    gens = rec.spans("engine.generate")
    assert gens
    kids = rec.children(gens)
    for g in gens:
        names = [c.name for c in kids[g.id]]
        assert names.count("engine.step") == 1, names
        assert names.count("engine.fetch") == 1, names
        assert names.count("engine.place") >= 2, names
        # step and fetch in that order, each inside the dispatch
        step = next(c for c in kids[g.id] if c.name == "engine.step")
        fetch = next(c for c in kids[g.id] if c.name == "engine.fetch")
        assert g.start_ns <= step.end_ns <= fetch.start_ns <= g.end_ns
        assert sum(c.ns for c in kids[g.id]) <= g.ns


@pytest.mark.parametrize("geo", [{}, {"sync_every": 2},
                                 {"prefill_chunk": 4}],
                         ids=["decode", "window", "chunked"])
def test_counters_give_the_runs_slot_occupancy_and_rows(geo):
    rec, res = _served(**geo)
    m = res.metrics
    steps = rec.counter("sched.decode_steps")
    assert steps == m["decode_steps"]
    assert rec.counter("sched.occupied_slot_steps") / (steps * 2) == \
        m["mean_slot_occupancy"]
    prompts = sum(c.prompt.shape[0] for c in res.completions)
    assert rec.counter("engine.prompt_tokens") == prompts
    rows = 8 * m["prefills"] if not m["prefill_chunk"] else \
        4 * m["prefill_units"]
    assert rec.counter("engine.prefill_rows") == rows
    # the dispatches' attributes hold the same counts
    gens = rec.spans("engine.generate")
    assert sum(g.attrs["steps"] for g in gens) == steps
    assert sum(g.attrs["steps"] * len(g.attrs["slots"]) for g in gens) == \
        rec.counter("sched.occupied_slot_steps")
    assert set(rec.summary()["counters"]) == set(COUNTERS)


def test_a_replay_is_a_span_of_its_dispatch():
    with trace.Recorder() as rec:
        man = _replayed()
    FAULT_LOG.clear()
    replays = rec.spans("engine.replay")
    assert man.retries > 0 and len(replays) == man.retries
    dispatches = {r.id: r.name for r in rec.records}
    assert {dispatches[r.parent] for r in replays} <= {"engine.prefill",
                                                       "engine.generate"}
    for r in replays:
        kids = [c.name for c in rec.records if c.parent == r.id]
        assert kids == ["engine.step", "engine.fetch"]


def test_compile_counter_reads_the_recorder():
    with trace.Recorder() as rec, CompileCounter(names=("decode",)) as c:
        record_compile("decode")
        record_compile("nvcc:pim_matmul")
    record_compile("decode")                 # neither is armed now
    assert c.counts == {"decode": 1}
    assert rec.counter(trace.COMPILE, target="decode") == 1
    assert rec.counted(trace.COMPILE) == {(("target", "decode"),): 1,
                                          (("target", "nvcc:pim_matmul"),): 1}
    # a counters-only recorder keeps no spans, and arms nothing for them
    with CompileCounter() as only:
        assert trace.span("t.x") is trace.span("t.x")
        _tiny_cnn_forward()
    assert only._recorder.records == [] and only._recorder.fine == {}


def test_threads_lose_no_update():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.Recorder() as rec:
            def work():
                for _ in range(2000):
                    with trace.fine("t.fine", "k"):
                        pass
                    trace.count("t.count", 2)

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert rec.aggregate("t.fine")["k"][0] == 16 * 2000
    assert rec.counter("t.count") == 16 * 2000 * 2


@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_serve_metrics_json_has_a_trace_section(tmp_path, mode):
    path = tmp_path / "m.json"
    common = dict(layers=1, d_model=32, pim=True, metrics_json=str(path),
                  device="cpu")
    if mode == "static":
        t_serve.serve("qwen2.5-3b", batch=1, prompt_len=6, gen=2, **common)
    else:
        t_serve.serve_continuous("qwen2.5-3b", num_slots=2, num_requests=3,
                                 prompt_len=8, gen=3, seed=0, **common)
    data = json.loads(path.read_text())["trace"]
    spans = data["spans"]
    for name in ("pim.quantize", "pim.nibbles", "pim.pad", "b1.launch",
                 "attn.prompt"):
        assert spans[name]["count"] > 0
    for s in spans.values():
        assert set(s) == {"count", "total_ms", "self_ms"}
        assert 0 <= s["self_ms"] <= s["total_ms"] + 1e-9
    if mode == "static":
        assert data["counters"] == {}
        assert not any(n.startswith(("sched.", "engine."))
                       for n in spans)
    else:
        assert spans["engine.generate"]["count"] == \
            data["counters"]["sched.decode_steps"]
        assert spans["engine.prefill"]["count"] == 3
        assert set(data["counters"]) == set(COUNTERS)
