"""The reliability library in the port (``repro_torch.reliability``)
against the JAX package's (``repro.reliability``), on the CPU.

Parity: the checksum record (``col_i32`` bit for bit, ``col_f32`` and
``scale_sum`` within 1e-6 of the sums' magnitude: float32 sums in another
order), fault injection (for the same spec and seed, the corrupted
stores equal JAX's bit for bit and the reports are equal as JSON, on
single plans and on a converted reduced MoE LM, whose per-layer lists
stand for JAX's layer-stacked plans: dense attention projections and (L,
E) expert stacks),
detection (per-tag violation counts equal JAX's for every fault kind at
``sample`` and ``always``: ``exact-torch`` / ``exact-cuda`` against
``exact-jnp`` / ``exact-pallas`` in interpret mode, ``analog`` /
``analog-cuda`` against ``analog`` / ``analog-pallas``; no false positive
on clean plans) and the degradation machine (the same violations leave
the same strikes, repairs, degraded flag and metrics). Then the port's
own versions of ``tests/test_reliability.py``'s library tests. Both
packages run eagerly; the port's ``-cuda`` substrates take their plain
versions on CPU tensors."""
import json
import sys
import zipfile
from dataclasses import fields, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from hypo_compat import given, settings, st  # noqa: E402

from repro import engine as j_engine
from repro import reliability as j_rel
from repro.configs.base import get_config as j_get_config
from repro.core import pim as j_pim
from repro.kernels.pim_matmul import ops as j_pim_ops
from repro.launch import serve as j_serve
from repro.models import lm as j_lm
from repro.quant.nibbles import to_nibbles as j_to_nibbles
from repro.quant.quantize import quantize as j_quantize
from repro.reliability import degrade as j_degrade
from repro_torch import convert, engine
from repro_torch import reliability as rel
from repro_torch.core import pim
from repro_torch.kernels.pim_matmul import ops as pim_ops
from repro_torch.reliability import abft, degrade, faults

J_EXACT = {"exact-torch": "exact-jnp", "exact-cuda": "exact-pallas"}
J_ANALOG = {"analog": "analog", "analog-cuda": "analog-pallas"}
KINDS = {
    "clean": {},
    "bitflips": {"bitflips": 2},
    "stuck_planes": {"stuck_planes": 1, "stuck_value": 15},
    "dropped_chunks": {"dropped_chunks": 1},
    "adc_drift": {"adc_gain": 1.1},
    "mixed": {"bitflips": 1, "stuck_planes": 1, "stuck_value": -7,
              "dropped_chunks": 1, "adc_offset": 1e-3},
}


@pytest.fixture(autouse=True)
def _clean_fault_logs():
    j_rel.FAULT_LOG.clear()
    rel.FAULT_LOG.clear()
    yield
    j_rel.FAULT_LOG.clear()
    rel.FAULT_LOG.clear()


def _w(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(w, substrate="exact-torch", verify="always", tag="t", **cfg_kw):
    """A plan programmed by JAX (on ``substrate``'s JAX name) and the
    port's conversion of it (same codes, same record bytes)."""
    jname = {**J_EXACT, **J_ANALOG}.get(substrate, substrate)
    jplan = j_engine.program(jnp.asarray(w), j_pim.PimConfig(
        substrate=jname, verify=verify, abft_tag=tag, **cfg_kw))
    return jplan, convert.plan_from_reference(jplan, "cpu")


def _program(w, substrate, verify="always", tag="t", **cfg_kw):
    return engine.program(torch.from_numpy(w), pim.PimConfig(
        substrate=substrate, verify=verify, abft_tag=tag, **cfg_kw))


def _j_counts():
    jax.effects_barrier()
    snap = j_rel.FAULT_LOG.snapshot()
    return snap["violation_rows"], snap["total_violations"]


def _t_counts():
    snap = rel.FAULT_LOG.snapshot()
    return snap["violation_rows"], snap["total_violations"]


def _assert_plan_equals_jax(got, want, lead=None):
    """A port plan's stores equal a JAX plan's (``lead`` indexes a
    stacked JAX plan's leading axis)."""
    for f in faults._STORES:
        ref = np.asarray(getattr(want, f))
        if lead is not None:
            ref = ref[lead]
        t = getattr(got, f)
        assert t.dtype == convert.tensor_from_numpy(ref, "cpu").dtype, f
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=f)


# ---------------------------------------------------------------------------
# checksum records
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(17, 9), (64, 40), (3, 4, 24)])
def test_checksums_match_jax(shape):
    w = _w(shape, 0)
    kind = "experts" if len(shape) == 3 else "dense"
    jcfg = j_pim.PimConfig(substrate="exact-jnp", verify="always")
    tcfg = pim.PimConfig(substrate="exact-torch", verify="always")
    jplan = j_engine.program(jnp.asarray(w), jcfg, kind=kind)
    tplan = engine.program(torch.from_numpy(w), tcfg, kind=kind)
    jrec = getattr(jplan, "dense", jplan).abft
    trec = getattr(tplan, "dense", tplan).abft
    assert sorted(trec) == sorted(jrec) == ["col_f32", "col_i32",
                                            "scale_sum"]
    assert trec["col_i32"].dtype == torch.int32
    np.testing.assert_array_equal(trec["col_i32"].numpy(),
                                  np.asarray(jrec["col_i32"]))
    dense = getattr(tplan, "dense", tplan)
    mag = (dense.values.abs().float() * dense.scale).sum(-1)
    for name, scale in (("col_f32", mag), ("scale_sum",
                                           dense.scale.sum((-2, -1)))):
        got, want = trec[name].numpy(), np.asarray(jrec[name])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_less(np.abs(got - want),
                                     1e-6 * scale.numpy() + 1e-12)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "clean"])
def test_injection_matches_jax_bit_for_bit(kind):
    jplan, tplan = _pair(_w((40, 24), 1))
    spec = dict(target="*", seed=5, **KINDS[kind])
    jbad, jrep = j_rel.inject_tree(jplan, [j_rel.FaultModel(**spec)],
                                   _path="p/q")
    tbad, trep = rel.inject_tree(tplan, [rel.FaultModel(**spec)],
                                 _path="p/q")
    assert json.dumps(trep) == json.dumps(jrep)
    assert trep and all("store_delta" in e for e in trep)
    _assert_plan_equals_jax(tbad, jbad)
    for name, t in tplan.abft.items():       # the record is never touched
        assert torch.equal(tbad.abft[name], t)
    one, rep = rel.inject_dense(tplan, rel.FaultModel(**spec), "p/q")
    assert rep == trep and torch.equal(one.planes, tbad.planes)


@pytest.fixture(scope="module")
def lm_trees():
    """A reduced MoE LM (qwen3-moe-30b-a3b, 2 layers, d_model 32, 8
    experts) planned by JAX with verify on (exact-jnp), and its
    conversion: its attention projections are layer-stacked dense plans
    (per-layer lists in the port), its experts layer-stacked expert
    stacks. Both names index the same tree."""
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced(num_layers=2,
                                                     d_model=32, vocab=128)
    jplanned = j_serve.plan_params_for_pim(
        j_lm.init_lm(jcfg, jax.random.PRNGKey(0)),
        j_pim.PimConfig(substrate="exact-jnp", verify="always"))
    tree = (jcfg, jplanned,
            convert.planned_params_from_reference(jplanned, "cpu"))
    return {"dense": tree, "experts": tree}


TREE_SPECS = {
    "dense": [dict(target="layers/attn/wq_dh", seed=3, bitflips=3,
                   stuck_planes=1, stuck_value=9),
              dict(target="layers/attn/w[kv]_dh", seed=4, dropped_chunks=2,
                   adc_gain=0.9, sticky=False)],
    "experts": [dict(target="layers/moe/wi_edf", seed=6, bitflips=2,
                     stuck_planes=2, stuck_value=15, dropped_chunks=1),
                dict(target="*wo*", seed=7, adc_offset=1e-4)],
}


def _walk_plans(jtree, ttree, path=""):
    """(path, JAX plan, port list or plan) for every plan of a tree."""
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _walk_plans(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (j_pim.DensePlan, j_pim.ExpertStackedPlan)):
        yield path.lstrip("/"), jtree, ttree


@pytest.mark.parametrize("name", ["dense", "experts"])
def test_injected_layer_stacks_match_jax(name, lm_trees):
    """A per-layer list is JAX's one stacked plan: the same entries
    corrupted (``b`` over the L layers, or L * E experts row-major), the
    same report, the same tag on every layer."""
    _, jplanned, tplanned = lm_trees[name]
    specs = TREE_SPECS[name]
    jbad, jrep = j_rel.inject_tree(jplanned,
                                   [j_rel.FaultModel(**s) for s in specs])
    tbad, trep = rel.inject_tree(tplanned,
                                 [rel.FaultModel(**s) for s in specs])
    assert trep and json.dumps(trep) == json.dumps(jrep)
    assert {e["path"] for e in trep} >= {specs[0]["target"]}
    hit = 0
    for path, jplan, tlist in _walk_plans(jbad, tbad):
        jdense = getattr(jplan, "dense", jplan)
        assert isinstance(tlist, list)
        for layer, tplan in enumerate(tlist):
            tdense = getattr(tplan, "dense", tplan)
            assert tdense.cfg.abft_tag == path == jdense.cfg.abft_tag
            _assert_plan_equals_jax(tdense, jdense, lead=layer)
        hit += 1
    assert hit >= 4


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------
def _detect(substrate, mode, kind, shape=(40, 24), rows=5):
    jplan, tplan = _pair(_w(shape, 2), substrate, verify=mode,
                         tag=f"{substrate}/{kind}")
    spec = dict(target="*", seed=8, **KINDS[kind])
    jbad, _ = j_rel.inject_tree(jplan, [j_rel.FaultModel(**spec)], _path="p")
    tbad, _ = rel.inject_tree(tplan, [rel.FaultModel(**spec)], _path="p")
    x = _w((rows, shape[0]), 3)
    jname = {**J_EXACT, **J_ANALOG}[substrate]
    jout = j_engine.matmul(jnp.asarray(x), jbad, cfg=replace(
        jbad.cfg, substrate=jname))
    tout = engine.matmul(torch.from_numpy(x), tbad, cfg=replace(
        tbad.cfg, substrate=substrate))
    return jout, tout


@pytest.mark.parametrize("mode", ["sample", "always"])
@pytest.mark.parametrize("substrate", list(J_EXACT) + list(J_ANALOG))
def test_detection_counts_match_jax(substrate, mode):
    """Every fault kind, one fresh plan each: the port's per-tag
    violation rows and totals equal JAX's; a clean plan reports none."""
    for kind in KINDS:
        j_rel.FAULT_LOG.clear()
        rel.FAULT_LOG.clear()
        jout, tout = _detect(substrate, mode, kind)
        if substrate.startswith("exact"):
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        want, got = _j_counts(), _t_counts()
        assert got == want, (kind, got, want)
        if kind == "clean":
            assert got == ({}, 0), f"false positive on {substrate}"
        else:
            assert got[1] == 1, (kind, got)
        assert rel.FAULT_LOG.snapshot()["total_checks"] == 1


@pytest.mark.parametrize("substrate", ["exact-torch", "exact-cuda"])
def test_expert_stack_detection_matches_jax(substrate, lm_trees):
    """An expert stack checks each expert against its own slice of the
    record under the stack's one tag: the violating experts' counts
    equal those JAX's vmap lanes post."""
    _, jplanned, tplanned = lm_trees["experts"]
    spec = TREE_SPECS["experts"][:1]
    jbad, _ = j_rel.inject_tree(jplanned, [j_rel.FaultModel(**s)
                                           for s in spec])
    tbad, _ = rel.inject_tree(tplanned, [rel.FaultModel(**s) for s in spec])
    x = _w((3, jbad["layers"]["moe"]["wi_edf"].dense.k), 4)
    jplan = jax.tree.map(lambda a: a[0], jbad["layers"]["moe"]["wi_edf"])
    tplan = tbad["layers"]["moe"]["wi_edf"][0]
    jout = j_engine.matmul(jnp.asarray(x), jplan, cfg=replace(
        jplan.cfg, substrate=J_EXACT[substrate]))
    tout = engine.matmul(torch.from_numpy(x), tplan, cfg=replace(
        tplan.cfg, substrate=substrate))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    want, got = _j_counts(), _t_counts()
    assert got == want and got[1] > 0
    # one check per expert in both packages (JAX's vmap posts per lane)
    assert rel.FAULT_LOG.snapshot()["checks"] == \
        j_rel.FAULT_LOG.snapshot()["checks"] == {
            "layers/moe/wi_edf": tplan.num_experts}


# ---------------------------------------------------------------------------
# the degradation machine
# ---------------------------------------------------------------------------
def _machine_state(man):
    return (dict(man.strikes), dict(man.repair_counts), man.degraded,
            man.detections, man.repairs)


@pytest.mark.parametrize("sticky", [False, True])
def test_manager_matches_jax_after_the_same_violations(sticky):
    """The same plans, faults and verified matmuls: both machines see
    the same violations and end in the same state, metrics included."""
    jp, tp = _pair(_w((24, 16), 10), tag="p")
    jq, tq = _pair(_w((24, 16), 9), tag="q")
    spec = [dict(target="p", seed=2, bitflips=2, sticky=sticky),
            dict(target="q", seed=1, stuck_planes=1, stuck_value=15,
                 sticky=sticky)]
    policy = dict(repair_after=1, degrade_after=2)
    jman = j_rel.ReliabilityManager(
        {"p": jp, "q": jq}, [j_rel.FaultModel(**s) for s in spec],
        j_rel.ReliabilityPolicy(**policy))
    tman = rel.ReliabilityManager(
        {"p": tp, "q": tq}, [rel.FaultModel(**s) for s in spec],
        rel.ReliabilityPolicy(**policy))
    assert json.dumps(tman.injection_report) == \
        json.dumps(jman.injection_report)
    x = _w((2, 24), 11)
    for _ in range(3):
        for key in ("p", "q"):
            j_engine.matmul(jnp.asarray(x), jman.serving_params()[key])
            engine.matmul(torch.from_numpy(x), tman.serving_params()[key])
        jbad, tbad = jman.drain(), tman.drain()
        assert tbad == jbad
        jman.record_violations(jbad)
        tman.record_violations(tbad)
        assert tman.maybe_repair() == jman.maybe_repair()
        assert _machine_state(tman) == _machine_state(jman)
    assert tman.metrics() == jman.metrics()
    assert tman.degraded == sticky


def test_policy_fallbacks_and_validation():
    assert rel.ReliabilityPolicy().fallback_substrate == "exact-cuda"
    for name in ("exact-torch", "exact-jnp", "exact-pallas"):
        rel.ReliabilityPolicy(fallback_substrate=name)
    with pytest.raises(ValueError, match="exact substrate"):
        rel.ReliabilityPolicy(fallback_substrate="analog")
    # what is checked is each plan's own cfg.verify and a tripped dispatch
    # is replayed once: JAX's unread verify / max_retries are not knobs here
    assert {f.name for f in fields(rel.ReliabilityPolicy)} == {
        "repair_after", "degrade_after", "fallback_substrate"}
    assert set(rel.__all__) == set(j_rel.__all__) - {"collected",
                                                     "verified_scan"}


def test_collect_scope_defers_and_sums_per_tag():
    """Inside a scope nothing is recorded: the counts are summed per tag
    (on the plans' device) and reach the log only through ``deliver``."""
    tplan = _pair(_w((16, 8), 12), tag="a")[1]
    bad, _ = rel.inject_tree(tplan, [rel.FaultModel(seed=1, bitflips=1)],
                             _path="a")
    other = replace(bad, cfg=replace(bad.cfg,
                                                         abft_tag="b"))
    x = torch.from_numpy(_w((3, 16), 13))
    with abft.collect_scope() as scope:
        for plan in (bad, tplan, other, bad):
            engine.matmul(x, plan)
        assert rel.FAULT_LOG.snapshot()["total_checks"] == 0
    assert scope.names == ("a", "b")
    counts = scope.counts()
    assert counts.dtype == torch.int32 and counts.shape == (2,)
    assert counts[0] == 2 * counts[1] > 0
    assert abft.deliver(scope.names, counts.numpy()) == int(counts.sum())
    snap = rel.FAULT_LOG.snapshot()
    assert snap["violation_rows"] == {"a": int(counts[0]),
                                      "b": int(counts[1])}
    assert snap["total_checks"] == 0       # checks come from note_checks


# ---------------------------------------------------------------------------
# the port's versions of tests/test_reliability.py's library tests
# ---------------------------------------------------------------------------
def test_abft_record_is_optional():
    w = _w((16, 8), 0)
    off = _program(w, "exact-torch", verify="off", tag=None)
    on = _program(w, "exact-torch")
    assert off.abft is None
    assert set(on.abft) == {"col_i32", "col_f32", "scale_sum"}
    assert on.abft["col_i32"].shape == (16,)
    cs = rel.checksums(on.values, on.scale)
    assert torch.equal(cs["col_i32"], on.abft["col_i32"])
    moved = on.to("cpu")
    assert torch.equal(moved.abft["col_f32"], on.abft["col_f32"])
    stack = engine.program(torch.from_numpy(_w((3, 16, 8), 1)),
                           pim.PimConfig(verify="always"), kind="experts")
    assert stack.dense.abft["col_i32"].shape == (3, 16)
    e1 = stack.expert(1).abft
    assert torch.equal(e1["col_i32"], stack.dense.abft["col_i32"][1])
    assert stack.experts(1, 3).dense.abft["scale_sum"].shape == (2,)


def test_clean_plans_never_violate():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    for substrate in engine.available_substrates():
        noisy = substrate.startswith("analog")
        kw = {"read_noise_sigma": 0.01} if noisy else {}
        plan = _program(w, substrate, tag=substrate, **kw)
        mm_kw = {"rng": torch.Generator().manual_seed(2)} if noisy else {}
        engine.matmul(x, plan, **mm_kw)
        bad = rel.FAULT_LOG.drain()
        assert not bad, f"false positive on {substrate}: {bad}"
    snap = rel.FAULT_LOG.snapshot()
    assert snap["total_checks"] == len(engine.available_substrates())
    assert snap["total_violations"] == 0


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_exact_substrates_detect_every_storage_fault(seed):
    rng = np.random.default_rng(seed)
    k, n = int(rng.integers(8, 40)), int(rng.integers(8, 40))
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32))
    model = rel.FaultModel(
        target="*", seed=seed, bitflips=int(rng.integers(0, 3)),
        stuck_planes=int(rng.integers(0, 2)),
        stuck_value=int(rng.integers(0, 16)),
        dropped_chunks=int(rng.integers(0, 2)))
    for substrate in ("exact-torch", "exact-cuda"):
        plan = _program(w, substrate, tag=f"{substrate}/{seed}")
        bad_plan, report = rel.inject_tree(plan, [model], _path="p")
        engine.matmul(x, bad_plan)
        bad = rel.FAULT_LOG.drain()
        detectable = sum(e.get("store_delta") or 0 for e in report)
        if detectable > 0:
            assert bad, f"{substrate}: undetected fault (report={report})"
        elif not report:
            assert not bad, f"{substrate}: phantom violation {bad}"


def test_adc_drift_detected_on_exact_substrates():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    model = rel.FaultModel(target="*", seed=0, adc_gain=1.05)
    for substrate in ("exact-torch", "exact-cuda"):
        plan = _program(w, substrate, tag=substrate)
        bad_plan, report = rel.inject_tree(plan, [model], _path="p")
        assert report and all((e.get("store_delta") or 0) == 0
                              for e in report)
        engine.matmul(x, bad_plan)
        assert rel.FAULT_LOG.drain(), f"{substrate}: ADC drift undetected"


def test_sample_mode_detects_column_faults():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(16, 16)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    plan = _program(w, "exact-torch", verify="sample")
    bad_plan, report = rel.inject_tree(
        plan, [rel.FaultModel(target="*", seed=1, stuck_planes=1,
                              stuck_value=15)], _path="p")
    assert sum(e.get("store_delta") or 0 for e in report) > 0
    engine.matmul(x, bad_plan)
    assert rel.FAULT_LOG.drain()


def test_rowsum_matches_jax_kernel():
    """The fused route's int32 row-sums (the ABFT probe; the plain
    version on CPU tensors) equal JAX's Pallas kernel's (interpret mode)
    at awkward shapes."""
    rng = np.random.default_rng(5)
    for m, k, n in ((3, 17, 9), (8, 64, 33), (1, 5, 128)):
        a_q = j_quantize(jnp.asarray(rng.normal(size=(m, k)), jnp.float32),
                         bits=8, axis=(1,))
        w_q = j_quantize(jnp.asarray(rng.normal(size=(k, n)), jnp.float32),
                         bits=4, axis=(0,))
        a_planes = j_to_nibbles(a_q.values, 8)
        w_planes = j_to_nibbles(w_q.values, 4)
        w_scale = jnp.broadcast_to(w_q.scale.astype(jnp.float32), (1, n))
        jout, jrow = j_pim_ops.pim_matmul_fused(
            a_planes, w_planes, a_q.scale, w_scale, want_rowsum=True)
        t = [convert.tensor_from_numpy(a, "cpu")
             for a in (a_planes, w_planes, a_q.scale, w_scale)]
        out, row = pim_ops.pim_matmul_fused(*t, want_rowsum=True)
        assert row.dtype == torch.int32
        np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_fault_spec_roundtrip_and_validation(tmp_path):
    models = [rel.FaultModel(target="*wq*", seed=7, bitflips=2),
              rel.FaultModel(target="layers/mlp/*", stuck_planes=1,
                             stuck_value=15, sticky=False)]
    path = tmp_path / "spec.json"
    path.write_text(rel.dump_fault_spec(models))
    assert rel.load_fault_spec(str(path)) == models
    assert [m.to_dict() for m in j_rel.load_fault_spec(str(path))] == \
        [m.to_dict() for m in models]
    path.write_text('{"faults": [{"target": "*", "warp_core": 1}]}')
    with pytest.raises(ValueError, match="warp_core"):
        rel.load_fault_spec(str(path))


def test_fault_injection_is_deterministic():
    plan = _program(_w((20, 12), 8), "exact-torch")
    model = rel.FaultModel(target="*", seed=9, bitflips=3, stuck_planes=1)
    t1, r1 = rel.inject_tree(plan, [model], _path="a/b")
    t2, r2 = rel.inject_tree(plan, [model], _path="a/b")
    assert r1 == r2
    for f in faults._STORES:
        assert torch.equal(getattr(t1, f), getattr(t2, f))
    _, r3 = rel.inject_tree(plan, [model], _path="a/c")
    assert r3 != r1, "a different path draws different fault sites"
    assert torch.equal(t1.abft["col_i32"], plan.abft["col_i32"])
    assert rel.summarize(r1)["by_kind"] == {"bitflip": 3, "stuck_plane": 1}


def test_retarget_plans_preserves_structure(lm_trees):
    _, jplanned, planned = lm_trees["dense"]
    fb = rel.retarget_plans(planned, "exact-torch", verify="off")
    assert isinstance(fb["layers"]["moe"]["wi_edf"][0],
                      pim.ExpertStackedPlan)
    wq, src = fb["layers"]["attn"]["wq_dh"], planned["layers"]["attn"]["wq_dh"]
    assert isinstance(wq, list) and len(wq) == len(src) == 2
    for a, b in zip(wq, src):
        assert a.cfg.substrate == "exact-torch" and a.cfg.verify == "off"
        assert a.planes is b.planes and a.abft is b.abft
    assert src[0].cfg.abft_tag == "layers/attn/wq_dh"
    tags = degrade.armed_tags(planned)
    assert tags == j_degrade.armed_tags(jplanned)
    assert "layers/attn/wq_dh" in tags and len(tags) >= 6
    assert degrade.armed_tags(fb) == []
    sub = degrade._get_subtree(planned, "layers/attn/wq_dh")
    assert sub is src
    swapped = degrade._set_subtree(planned, "layers/attn/wq_dh", ["x"])
    assert swapped["layers"]["attn"]["wq_dh"] == ["x"]
    assert planned["layers"]["attn"]["wq_dh"] is src
    with pytest.raises(KeyError):
        degrade._get_subtree(planned, "layers/nope")


def test_manager_repair_clears_transient_fault():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    plan = _program(rng.normal(size=(24, 16)).astype(np.float32),
                    "exact-torch", tag="p")
    man = rel.ReliabilityManager(
        {"p": plan},
        [rel.FaultModel(target="*", seed=2, bitflips=2, sticky=False)],
        rel.ReliabilityPolicy(repair_after=1, degrade_after=3))
    assert man.injection_report
    engine.matmul(x, man.params["p"])
    bad = man.drain()
    assert bad
    man.record_violations(bad)
    assert man.maybe_repair()
    assert man.repairs == 1 and not man.degraded
    engine.matmul(x, man.params["p"])
    assert not man.drain(), "repaired plan must verify clean"


def test_manager_sticky_fault_degrades():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    plan = _program(rng.normal(size=(24, 16)).astype(np.float32),
                    "exact-torch", tag="p")
    man = rel.ReliabilityManager(
        {"p": plan},
        [rel.FaultModel(target="*", seed=2, bitflips=2, sticky=True)],
        rel.ReliabilityPolicy(repair_after=1, degrade_after=2))
    for round_ in range(2):
        engine.matmul(x, man.params["p"])
        bad = man.drain()
        assert bad, f"sticky fault must re-violate (round {round_})"
        man.record_violations(bad)
        man.maybe_repair()
    assert man.degraded
    fb = man.serving_params()
    assert fb["p"].cfg.verify == "off"
    assert fb["p"].cfg.resolved_substrate == "exact-cuda"
    assert torch.equal(engine.matmul(x, fb["p"]), engine.matmul(x, plan))
    assert not man.drain()


def test_load_plans_detects_corrupt_leaf(tmp_path):
    plans = {"layers": {"wq": _program(_w((16, 8), 12), "exact-torch")}}
    d = str(tmp_path / "plans")
    engine.save_plans(d, plans)
    restored, _, _ = engine.load_plans(d, device="cpu")
    for name, t in plans["layers"]["wq"].abft.items():
        assert torch.equal(restored["layers"]["wq"].abft[name], t)
    npz = next(Path(d).rglob("arrays.npz"))
    with zipfile.ZipFile(npz) as z:
        names = z.namelist()
        blobs = {nm: bytearray(z.read(nm)) for nm in names}
    victim = sorted(names)[-1]               # the record's scale_sum
    blobs[victim][-1] ^= 0xFF
    with zipfile.ZipFile(npz, "w") as z:
        for nm in names:
            z.writestr(nm, bytes(blobs[nm]))
    with pytest.raises(engine.PlanCorruptionError) as ei:
        engine.load_plans(d, device="cpu")
    assert ei.value.leaf_path == "layers/wq.4/scale_sum"
