"""Plan persistence parity: the port's ``engine.save_plans`` /
``load_plans`` against the JAX package's, on the same plans (JAX's,
carried over by ``repro_torch.convert``), in both directions.

Three trees, at reduced sizes: a dense LM's planned parameters
(``qwen3-4b``, 2 layers, d_model 64: vmapped plans in JAX, per-layer
lists in the port), a CNN's plans with depthwise layers (``mobilenet``,
16x16, width 0.25) and an expert-stacked MoE LM (``qwen3-moe-30b-a3b``,
1 layer, d_model 32, 8 experts); the two LM trees also programmed with
ABFT verification on (``verify="always"``: each plan carries its
checksum record, a dict child of the plan). Everything is compared bit
for bit: the
two packages' manifests equal as JSON, their ``arrays.npz`` members equal
array for array, restored plans equal the originals field for field and
run bit-identically on ``exact-torch``; a flipped byte names the same
leaf in both packages.
"""
import io
import json
import os
import shutil
import zipfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as j_engine
from repro.configs.base import get_config as j_get_config
from repro.core import workloads as j_workloads
from repro.core.pim import PimConfig as JPimConfig
from repro.engine import persist as j_persist
from repro.launch import serve as j_serve
from repro.models import cnn as j_cnn
from repro.models import lm as j_lm
from repro_torch import convert, engine
from repro_torch.core import pim, workloads
from repro_torch.data.pipeline import synthetic_images
from repro_torch.engine import persist
from repro_torch.launch import serve as t_serve
from repro_torch.models import cnn, lm

TREES = ("dense", "cnn", "experts", "dense-abft", "experts-abft")
JCFG = JPimConfig(weight_bits=4, act_bits=4, substrate="exact-jnp")
JCFG_ABFT = JPimConfig(weight_bits=4, act_bits=4, substrate="exact-jnp",
                       verify="always")


def _lm_tree(arch, layers, d_model, vocab, pim_cfg=JCFG):
    jcfg = j_get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                      vocab=vocab)
    jparams = j_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    jplanned = j_serve.plan_params_for_pim(jparams, pim_cfg)
    return {"cfg": convert.model_config_from_reference(jcfg),
            "jax": jplanned,
            "port": convert.planned_params_from_reference(jplanned, "cpu")}


def _cnn_tree():
    jlayers = j_workloads.mobilenet(8, 16, width=0.25)
    jparams = j_cnn.init_cnn(jlayers, jax.random.PRNGKey(0))
    jplans = j_cnn.plan_cnn_weights(jparams, jlayers, JCFG)
    return {"layers": workloads.mobilenet(8, 16, width=0.25),
            "params": convert.params_from_reference(jparams, "cpu"),
            "jax": jplans,
            "port": convert.plans_from_reference(jplans, "cpu")}


@pytest.fixture(scope="module")
def trees():
    return {"dense": _lm_tree("qwen3-4b", 2, 64, 128),
            "cnn": _cnn_tree(),
            "experts": _lm_tree("qwen3-moe-30b-a3b", 1, 32, 64),
            "dense-abft": _lm_tree("qwen3-4b", 2, 64, 128, JCFG_ABFT),
            "experts-abft": _lm_tree("qwen3-moe-30b-a3b", 1, 32, 64,
                                     JCFG_ABFT)}


@pytest.fixture(scope="module")
def jax_saved(trees, tmp_path_factory):
    """JAX -> port: each tree saved by the JAX package."""
    root = tmp_path_factory.mktemp("jax_saved")
    out = {}
    for name in TREES:
        d = str(root / name)
        j_engine.save_plans(d, trees[name]["jax"], extras={"note": name})
        out[name] = d
    return out


@pytest.fixture(scope="module")
def port_saved(trees, tmp_path_factory):
    """Port -> JAX: each converted tree saved by the port, and what the
    JAX package restores from it."""
    root = tmp_path_factory.mktemp("port_saved")
    out = {}
    for name in TREES:
        d = str(root / name)
        engine.save_plans(d, trees[name]["port"], extras={"note": name})
        out[name] = (d, j_engine.load_plans(d))
    return out


def _manifest(d):
    with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
        return json.load(f)


def _members(d):
    return np.load(os.path.join(d, "step_00000000", "arrays.npz"))


def _assert_plans_equal(got, want):
    """Two port trees equal: plans field for field (and config), tensors
    bit for bit."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_plans_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_plans_equal(g, w)
    elif isinstance(want, pim.ExpertStackedPlan):
        assert got.num_experts == want.num_experts
        _assert_plans_equal(got.dense, want.dense)
    elif isinstance(want, pim.Plan):
        assert type(got) is type(want) and got.cfg == want.cfg
        assert got.bits == want.bits
        assert getattr(got, "k", 0) == getattr(want, "k", 0)
        assert getattr(got, "n", 0) == getattr(want, "n", 0)
        for f in persist._fields(want):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        want_abft = getattr(want, "abft", None)
        if want_abft is None:
            assert getattr(got, "abft", None) is None
        else:
            assert sorted(got.abft) == sorted(want_abft)
            for name, t in want_abft.items():
                assert got.abft[name].dtype == t.dtype
                assert torch.equal(got.abft[name], t), name
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _run(name, tree, plans):
    """The tree's forward on ``exact-torch`` (its plans' substrate)."""
    if name == "cnn":
        x, _ = synthetic_images(0, 2, 16, 8)
        return cnn.cnn_forward(tree["params"], tree["layers"],
                               torch.from_numpy(x), pim=pim.PimConfig(
                                   substrate="exact-torch"), plans=plans)
    cfg = tree["cfg"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 6)))
    logits, cache = lm.prefill(plans, cfg, {"tokens": toks}, 8)
    step, _ = lm.decode_step(plans, cfg, cache, logits.argmax(-1)[:, None],
                             6)
    return torch.cat([logits, step])


@pytest.mark.parametrize("name", TREES)
def test_both_packages_write_the_same_directory(name, jax_saved,
                                                port_saved):
    jd, (td, _) = jax_saved[name], port_saved[name]
    assert _manifest(td) == _manifest(jd)
    jm, tm = _members(jd), _members(td)
    assert sorted(tm.files) == sorted(jm.files)
    for member in jm.files:
        assert tm[member].dtype == jm[member].dtype, member
        np.testing.assert_array_equal(tm[member], jm[member],
                                      err_msg=member)


@pytest.mark.parametrize("name", TREES)
def test_jax_directory_restores_in_port(name, trees, jax_saved):
    plans, step, extras = engine.load_plans(jax_saved[name], device="cpu")
    assert step == 0 and extras == {"note": name}
    _assert_plans_equal(plans, trees[name]["port"])
    assert torch.equal(_run(name, trees[name], plans),
                       _run(name, trees[name], trees[name]["port"]))


@pytest.mark.parametrize("name", TREES)
def test_port_directory_restores_in_jax(name, trees, port_saved):
    _, (restored, step, extras) = port_saved[name]
    want = trees[name]["jax"]
    assert step == 0 and extras == {"note": name}
    assert jax.tree.structure(restored) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # the restored plans run: one planned matmul, bit for bit
    plan = (restored["pw0"] if name == "cnn" else
            restored["layers"]["attn"]["wq_dh"])
    ref_plan = want["pw0"] if name == "cnn" else \
        want["layers"]["attn"]["wq_dh"]
    if name != "cnn":   # a vmapped plan: its first layer
        plan, ref_plan = (jax.tree.map(lambda a: a[0], p)
                          for p in (plan, ref_plan))
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (3, plan.k)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(j_engine.matmul(x, plan)),
                                  np.asarray(j_engine.matmul(x, ref_plan)))


@pytest.mark.parametrize("name", TREES)
def test_describe_template_and_leaf_names_match_jax(name, trees):
    port_tree, jax_tree = trees[name]["port"], trees[name]["jax"]
    spec = persist.describe_plan_tree(port_tree)
    assert spec == json.loads(json.dumps(
        j_persist.describe_plan_tree(jax_tree)))
    template = persist.build_plan_template(spec)
    _assert_shapes(template, port_tree)
    n = len(jax.tree.leaves(jax_tree))
    for i in range(n):
        assert persist._leaf_path_name(port_tree, i) == \
            j_persist._leaf_path_name(jax_tree, i)
    assert persist._leaf_path_name(port_tree, n) == f"<leaf {n}>"


def _assert_shapes(template, tree):
    if isinstance(tree, dict):
        for k in tree:
            _assert_shapes(template[k], tree[k])
    elif isinstance(tree, list):
        assert len(template) == len(tree)
        for t, w in zip(template, tree):
            _assert_shapes(t, w)
    elif isinstance(tree, pim.Plan):
        src = getattr(tree, "dense", tree)
        got = getattr(template, "dense", template)
        assert got.cfg == src.cfg
        for f in persist._fields(src):
            t = getattr(got, f)
            assert t.device.type == "meta"
            assert t.shape == getattr(src, f).shape
            assert t.dtype == getattr(src, f).dtype
    else:
        assert template.shape == tree.shape and template.dtype == tree.dtype


def _flip_member(d, member):
    npz = os.path.join(d, "step_00000000", "arrays.npz")
    with zipfile.ZipFile(npz) as z:
        blobs = {nm: bytearray(z.read(nm)) for nm in z.namelist()}
    blobs[member][-1] ^= 0xFF           # flip a payload byte
    with zipfile.ZipFile(npz, "w") as z:
        for nm, blob in blobs.items():
            z.writestr(nm, bytes(blob))


def test_corrupt_leaf_names_the_same_leaf_in_both_packages(jax_saved,
                                                          tmp_path):
    d = str(tmp_path / "plans")
    shutil.copytree(jax_saved["dense"], d)
    spec = _manifest(d)["extras"]["engine_plans"]
    paths = persist._spec_paths(spec)
    victim = next(i for i, p in enumerate(paths)
                  if ("d", "wq_dh") in p and p[-1] == ("i", 2))
    _flip_member(d, f"leaf_{victim:05d}.npy")
    with pytest.raises(j_engine.PlanCorruptionError) as jerr:
        j_engine.load_plans(d)
    with pytest.raises(engine.PlanCorruptionError) as terr:
        engine.load_plans(d, device="cpu")
    assert terr.value.leaf_path == jerr.value.leaf_path == \
        "layers/attn/wq_dh.2"
    assert terr.value.leaf_index == jerr.value.leaf_index == victim
    assert isinstance(terr.value, engine.PlanCorruptionError)


def _edit_spec(src, dst, edit):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "step_00000000", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    edit(manifest["extras"]["engine_plans"])
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


def test_shard_stamps_restore_unsharded_with_a_warning(port_saved,
                                                       tmp_path):
    def stamp(spec):
        spec["items"]["pw0"]["shard"] = {"kind": "col", "axis": "model"}
    d = _edit_spec(port_saved["cnn"][0], str(tmp_path / "sharded"), stamp)
    with pytest.warns(UserWarning, match="shard stamp.*pw0"):
        plans, _, _ = engine.load_plans(d, device="cpu")
    with pytest.warns(UserWarning, match="shard stamp.*pw0"):
        j_engine.load_plans(d)
    assert isinstance(plans["pw0"], pim.DensePlan)


def test_mesh_and_verify_raise_their_items(port_saved, tmp_path):
    """A11 and A9 are ported: ``mesh=`` re-places a directory on a mesh
    (here one rank, so nothing splits and every plan restores whole; the
    splits are ``tests/test_torch_mesh.py``'s), and a spec whose plan has
    verify on loads in both packages, its config as saved."""
    from repro_torch.launch.mesh import make_serve_mesh
    plans, _, _ = engine.load_plans(port_saved["cnn"][0],
                                    mesh=make_serve_mesh("1,1", "cpu"))
    assert isinstance(plans["pw0"], pim.DensePlan)
    assert plans["pw0"].shard is None

    def verify(spec):
        spec["items"]["pw0"]["cfg"]["verify"] = "sample"
    d = _edit_spec(port_saved["cnn"][0], str(tmp_path / "verify"), verify)
    plans, _, _ = engine.load_plans(d, device="cpu")
    assert plans["pw0"].cfg.verify == "sample" and plans["pw0"].abft is None
    jplans, _, _ = j_engine.load_plans(d)
    assert jplans["pw0"].cfg.verify == "sample"


def test_missing_and_unspecced_directories(tmp_path):
    from repro_torch.checkpoint.ckpt import save_checkpoint
    with pytest.raises(FileNotFoundError):
        engine.load_plans(str(tmp_path / "nope"), device="cpu")
    d = str(tmp_path / "plain")
    save_checkpoint(d, 0, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="engine_plans"):
        engine.load_plans(d, device="cpu")


def test_stacked_plans_restore_as_views_of_one_tensor(jax_saved):
    plans, _, _ = engine.load_plans(jax_saved["dense"], device="cpu")
    wq = plans["layers"]["attn"]["wq_dh"]
    assert isinstance(wq, list) and len(wq) == 2
    assert wq[0].planes.untyped_storage().data_ptr() == \
        wq[1].planes.untyped_storage().data_ptr()
    experts, _, _ = engine.load_plans(jax_saved["experts"], device="cpu")
    stack = experts["layers"]["moe"]["wi_edf"]
    assert isinstance(stack[0], pim.ExpertStackedPlan)
    assert stack[0].dense.planes.dim() == 4


SERVE = dict(layers=2, d_model=64, batch=1, prompt_len=8, gen=3,
             pim=True, device="cpu")


def _serve(d, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        res = t_serve.serve("qwen3-4b", plan_dir=d, **dict(SERVE, **kw))
    return res, out.getvalue()


def test_serve_plan_dir_restores_and_reprograms(tmp_path):
    d = str(tmp_path / "plans")
    res1, log1 = _serve(d)
    assert "saved programmed plans" in log1
    res2, log2 = _serve(d)
    assert "restored programmed plans" in log2
    np.testing.assert_array_equal(res1["generated"], res2["generated"])
    plain = t_serve.serve("qwen3-4b", **SERVE)
    np.testing.assert_array_equal(res1["generated"], plain["generated"])
    # a checkpoint programmed for another operating point or geometry is
    # stale: serving re-programs (and re-saves) instead of reusing it
    _, log3 = _serve(d, pim_bits=8)
    assert "re-programming" in log3 and "saved" in log3
    assert engine.load_plans(d, device="cpu")[2]["weight_bits"] == 8
    res4, log4 = _serve(d, d_model=48)
    assert "re-programming" in log4
    assert res4["generated"].shape == (1, 3)
    assert engine.load_plans(d, device="cpu")[2]["d_model"] == 48


def test_serve_plan_dir_reprograms_a_corrupt_checkpoint(tmp_path):
    d = str(tmp_path / "plans")
    res1, _ = _serve(d)
    _flip_member(d, "leaf_00003.npy")
    res2, log2 = _serve(d)
    assert "could not restore" in log2 and "PlanCorruptionError" in log2
    assert "saved programmed plans" in log2
    np.testing.assert_array_equal(res1["generated"], res2["generated"])
    _, log3 = _serve(d)
    assert "restored programmed plans" in log3


def test_serve_plan_dir_extras_have_jax_keys(tmp_path):
    d = str(tmp_path / "plans")
    _serve(d)
    extras = engine.load_plans(d, device="cpu")[2]
    jax_keys = {"substrate", "weight_bits", "act_bits", "abft", "arch",
                "num_layers", "d_model", "vocab_size", "mesh",
                "params_digest"}
    assert set(extras) == jax_keys
    assert extras["substrate"] == "exact-cuda"
    assert t_serve._same_extras(dict(extras, substrate="exact-pallas"),
                                extras)
    assert not t_serve._same_extras(dict(extras, params_digest="0"),
                                    extras)


def test_params_digest_hashes_each_leaf_as_stacked(tmp_path):
    """The per-leaf digests fed layer by layer equal the sha256 of each
    stacked float leaf, combined in JAX's leaf order."""
    import hashlib
    cfg = t_serve.get_config("qwen3-4b").reduced(num_layers=2, d_model=64,
                                                 vocab=128)
    params = lm.init_lm(cfg, 0, device="cpu")
    leaves = sorted(t_serve._dict_leaves(params))
    want = hashlib.sha256("".join(
        hashlib.sha256(t.numpy().tobytes()).hexdigest()
        for _, t in leaves).encode()).hexdigest()[:16]
    assert t_serve._params_digest(cfg, "cpu") == want
