"""The mesh in the port (``repro_torch.launch.mesh``,
``repro_torch.engine.mesh``, ``distributed/sharding.py``, the MoE
expert-parallel branch, ``load_plans(mesh=)``, serving with ``mesh=``).

One gloo group of 4 ranks on the CPU, spawned once for the file
(``torch_mesh_worker.py``), runs each request on every rank; the ranks'
sharded results are held to the port's single-device results, which
``tests/test_torch_engine.py`` holds to JAX eager, bit for bit on the
exact substrates (``exact-cuda`` runs its plain version here). The JAX
side runs in this process: the rule table, JAX's MoE oracle, and plan
directories written by either package loaded by the other (JAX's in one
small subprocess with 4 forced host devices).
"""
import json
import multiprocessing
import os
import queue
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as j_get_config
from repro.distributed import sharding as j_sharding
from repro.engine import load_plans as j_load_plans
from repro.engine import matmul as j_matmul
from repro.engine import mesh as j_mesh
from repro.engine import persist as j_persist
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch import convert
from repro_torch.distributed import sharding
from repro_torch.engine import mesh as t_mesh
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve as t_serve

import torch_mesh_worker as worker

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
REQUEST_TIMEOUT_S = 240     # each test's bound on its ranks' replies
SERVE = dict(arch="qwen3-4b", layers=2, d_model=64, pim=True, device="cpu")


class Ranks:
    """The spawned group: ``run(name, **kwargs)`` sends one request to
    every rank and returns the replies in rank order."""

    def __init__(self, tmp):
        ctx = multiprocessing.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(
            target=worker.serve_rank,
            args=(r, WORLD, str(tmp / "gloo_init"), self.inboxes[r],
                  self.outbox), daemon=True) for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name, **kwargs):
        for box in self.inboxes:
            box.put((name, kwargs))
        replies = {}
        try:
            while len(replies) < WORLD:
                rank, status, value = self.outbox.get(
                    timeout=REQUEST_TIMEOUT_S)
                if status != "ok":
                    raise AssertionError(f"rank {rank}: {value}")
                replies[rank] = value
        except queue.Empty:
            raise AssertionError(
                f"{name}: ranks {sorted(set(range(WORLD)) - set(replies))}"
                f" gave no reply within {REQUEST_TIMEOUT_S} s") from None
        return [replies[r] for r in range(WORLD)]

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = Ranks(tmp_path_factory.mktemp("mesh"))
    try:
        yield group
    finally:
        group.close()
    assert not any(p.is_alive() for p in group.procs)


# ---------------------------------------------------------------------------
# splits on the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("substrate", ("exact-cuda", "exact-torch"))
def test_dense_splits_bit_exact(ranks, substrate, bits):
    """Column (bias fused on its slice) and row splits on a 2x2 mesh equal
    the unsplit plan bit for bit, at an M the data axis divides (rows
    split and gathered) and one it does not."""
    for rank, cases in enumerate(ranks.run("dense_splits",
                                           substrate=substrate, bits=bits)):
        assert cases and all(cases.values()), (rank, cases)


def test_emulate_col_within_tolerance(ranks):
    """``emulate`` runs a float matmul, whose reduction order may differ
    on a column block: held to 1e-5 of the output's largest magnitude."""
    for gap, scale in ranks.run("emulate_col"):
        assert gap <= 1e-5 * scale, (gap, scale)


@pytest.mark.parametrize("paired", (False, True))
@pytest.mark.parametrize("substrate", ("exact-torch", "analog"))
def test_expert_split_bit_exact(ranks, substrate, paired):
    """Expert splits equal the unsplit stack on every substrate, analog
    included (its auto-range is per expert)."""
    assert all(ranks.run("expert_split", substrate=substrate,
                         paired=paired))


def test_split_refusals(ranks):
    """The reference's refusals: analog dense splits, N or E the axis does
    not divide, ``spec=`` without a mesh, ``rng=`` and ``paired=`` on a
    split dense plan; the tree walk replicates instead of raising."""
    for cases in ranks.run("refusals"):
        assert len(cases) == 8 and all(cases.values()), cases


@pytest.mark.parametrize("chunk_elements", (1 << 27, 6 * 32 * 3))
@pytest.mark.parametrize("substrate", ("exact-torch", "analog"))
def test_moe_pim_on_split_stacks_bit_exact(ranks, substrate,
                                           chunk_elements):
    """``_moe_pim`` on expert-split stacks equals the unsplit layer bit
    for bit: one chunk of all 8 experts, and chunks of 3 that straddle the
    ranks' blocks of 4 (pieces of unequal size, combined in order)."""
    assert all(ranks.run("moe_pim_split", substrate=substrate,
                         chunk_elements=chunk_elements))


@pytest.mark.parametrize("spec", ("2,2", "1,4"))
def test_moe_ep_branch(ranks, spec):
    """The float expert-parallel branch of ``moe_apply`` under a sharding
    context, on JAX's own test case (``moe_init(32, 8, 16)``, 4 x 128
    tokens, top-2): against JAX's ``moe_reference`` by JAX's criterion
    (fewer than 5% of tokens off by more than 1e-3; the capacity factor
    1.25 may drop a few), and with a capacity that drops nothing against
    ``_moe_local`` within 1e-5."""
    p = j_moe.moe_init(jax.random.PRNGKey(0), 32, 8, 16)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 128, 32))
    ref = np.asarray(j_moe.moe_reference(p, x, 2))
    params = {k: np.asarray(v) for k, v in p.items()}
    for out, nodrop_gap in ranks.run("moe_ep", params=params,
                                     x=np.asarray(x), k=2, spec=spec):
        per_tok = np.abs(out - ref).max(axis=-1).reshape(-1)
        assert np.mean(per_tok > 1e-3) < 0.05, np.mean(per_tok > 1e-3)
        assert nodrop_gap <= 1e-5, nodrop_gap


# ---------------------------------------------------------------------------
# plan directories
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_stamped(ranks, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_stamped"))
    replies = ranks.run("write_stamped", directory=d)
    return d, replies


def test_load_plans_with_and_without_mesh(ranks, port_stamped):
    """A stamped directory written on the mesh restores with ``mesh=``
    (each rank its slices, the saved kinds) and without (whole plans,
    stamps dropped with the warning), both equal to the unsplit tree."""
    d, written = port_stamped
    assert all(r["split_equal"] for r in written)
    for got in ranks.run("load_stamped", directory=d):
        assert got["equal"] and got["warned"]
        assert got["extras"] == {"mesh": "2,2"}
        kinds = {re.sub(r"\[\d+\]", "", p): k for p, k in got["kinds"]}
        assert kinds == {"layers/attn/wq_dh": "col",
                         "layers/attn/wo_hd": "row",
                         "layers/moe/wi_edf": "expert"}
        assert {k for _, k in got["whole_kinds"]} == {None}


def test_port_stamped_directory_loads_in_jax(port_stamped):
    """JAX's ``load_plans`` reads the port's stamped directory: the same
    stamps (JAX's ``_shard_stamps`` of the saved spec), whole plans with
    its warning, and outputs equal to the port's unsplit plans'."""
    d, written = port_stamped
    with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
        spec = json.load(f)["extras"]["engine_plans"]
    assert [tuple(s) for s in j_persist._shard_stamps(spec)] == \
        [tuple(s) for s in written[0]["stamps"]]
    with pytest.warns(UserWarning, match="shard stamp"):
        jplans, _, _ = j_load_plans(d)
    x = jnp.asarray(worker._rand((6, 64), 70).numpy())
    xh = jnp.asarray(worker._rand((6, 48), 71).numpy())
    for name, block in (("wq_dh", "attn"), ("wo_hd", "attn"),
                        ("wi_edf", "moe")):
        stacked = jplans["layers"][block][name]
        for i in range(2):
            plan = jax.tree.map(lambda a, i=i: a[i], stacked)
            got = np.asarray(j_matmul(xh if name == "wo_hd" else x, plan))
            np.testing.assert_array_equal(
                got, written[0]["outputs"][f"{name}.{i}"])


@pytest.mark.parametrize("partway", (False, True))
def test_failed_save_raises_on_every_rank(ranks, tmp_path, partway):
    """When rank 0 cannot write the directory (its path lies under a
    regular file) or fails partway (a full disk at the third leaf), it
    still joins the other ranks' gathers: every rank returns with an
    OSError, and the group's collectives stay paired."""
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    d = str(tmp_path / "plans") if partway else str(blocker / "plans")
    for rank, got in enumerate(ranks.run("save_fails", directory=d,
                                         partway=partway)):
        assert got["raised"] and got["raised"].split(":")[0] in (
            "OSError", "FileExistsError", "NotADirectoryError"), (rank, got)
        assert got["after"] == WORLD, (rank, got)


JAX_WRITER = r"""
import sys
import jax
from repro import engine
from repro.configs.base import get_config
from repro.core.pim import PimConfig
from repro.launch.mesh import make_serve_mesh
from repro.launch.serve import plan_params_for_pim
from repro.models.lm import init_lm
cfg = get_config("qwen3-4b").reduced(num_layers=2, d_model=64, vocab=64)
planned = plan_params_for_pim(init_lm(cfg, jax.random.PRNGKey(0)),
                              PimConfig(substrate="exact-jnp"))
engine.save_plans(sys.argv[1],
                  engine.shard_plan_tree(planned, make_serve_mesh("2,2")))
"""


def test_jax_stamped_directory_loads_on_the_mesh(ranks, tmp_path):
    """A directory JAX programs and saves on a 2x2 mesh (reduced qwen3-4b)
    restores on the port's mesh with JAX's split kinds, and its split
    plans equal the same directory restored whole."""
    d = str(tmp_path / "jax_stamped")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", JAX_WRITER, d], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
        spec = json.load(f)["extras"]["engine_plans"]
    want = {p: s["kind"] for p, s in j_persist._shard_stamps(spec)}
    assert set(want.values()) == {"col", "row"}
    for got in ranks.run("load_stamped", directory=d, own_tree=False):
        kinds = {re.sub(r"\[\d+\]", "", p): k for p, k in got["kinds"]
                 if k is not None}
        assert kinds == want and got["equal"] and got["warned"]


# ---------------------------------------------------------------------------
# serving and the rule table
# ---------------------------------------------------------------------------
def test_serve_continuous_on_a_mesh(ranks):
    """``serve_continuous(..., mesh="2,2")`` on 4 ranks: every rank's
    token streams equal the single-process run's, and the result names
    the mesh and its backend."""
    want = t_serve.serve_continuous(**SERVE)
    want = {r["id"]: np.asarray(r["tokens"]).tolist()
            for r in want["requests"]}
    replies = ranks.run("serve_mesh", kwargs=dict(SERVE, mesh="2,2"))
    assert len({r["pid"] for r in replies}) == WORLD
    for got in replies:
        assert got["tokens"] == want
        assert (got["mesh"], got["backend"], got["ranks"]) == \
            ("2,2", "gloo", WORLD)


FAMILIES = ("whisper-medium", "paligemma-3b")
FAMILY_SERVE = dict(layers=2, d_model=64, pim=True, device="cpu",
                    pim_substrate="exact-torch")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_static_serve_on_a_mesh(ranks, arch):
    """``serve(..., mesh="2,2")`` of the reduced encoder-decoder and VLM
    (both stacks' plans and the cross-attention's split, the patch
    projector whole): every rank's tokens equal the single-process
    serve's bit for bit on exact-torch."""
    want = t_serve.serve(arch, **FAMILY_SERVE)["generated"].tolist()
    for got in ranks.run("serve_static_mesh",
                         kwargs=dict(FAMILY_SERVE, arch=arch, mesh="2,2")):
        assert got["generated"] == want
        assert (got["mesh"], got["backend"], got["ranks"]) == \
            ("2,2", "gloo", WORLD)


JAX_FAMILY_KINDS = r"""
import json
import jax
from repro.configs.base import get_config
from repro.core import pim
from repro.core.pim import PimConfig
from repro.engine import shard_plan_tree
from repro.launch.mesh import make_serve_mesh
from repro.launch.serve import plan_params_for_pim
from repro.models.lm import init_lm
out = {}
for arch in ("whisper-medium", "paligemma-3b"):
    cfg = get_config(arch).reduced(num_layers=2, d_model=64, vocab=64)
    planned = plan_params_for_pim(init_lm(cfg, jax.random.PRNGKey(0)),
                                  PimConfig(substrate="exact-jnp"))
    placed = shard_plan_tree(planned, make_serve_mesh("2,2"))
    flat = jax.tree_util.tree_flatten_with_path(
        placed, is_leaf=lambda x: isinstance(x, pim.Plan))[0]
    out[arch] = {"/".join(str(k.key) for k in path):
                 None if leaf.shard is None else leaf.shard.kind
                 for path, leaf in flat if isinstance(leaf, pim.Plan)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_family_kinds():
    """JAX's ``shard_plan_tree`` of both reduced families' planned trees
    on a 2x2 mesh (one subprocess with 4 forced host devices): path ->
    split kind of each stacked plan."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", JAX_FAMILY_KINDS], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_plan_kinds_match_jax(ranks, jax_family_kinds, arch):
    """The port's placement of the same planned tree (JAX's parameters,
    converted) gives every plan JAX's split kind: ``enc_layers`` and
    ``xattn`` by leaf name, like the decoder's; the patch projector
    ``vproj_dh`` is a float leaf and stays whole on every rank."""
    cfg = j_get_config(arch).reduced(num_layers=2, d_model=64, vocab=64)
    params = convert.params_from_reference(
        j_lm.init_lm(cfg, jax.random.PRNGKey(0)), "cpu")
    want = jax_family_kinds[arch]
    stacks = {p.split("/")[0] for p in want}
    assert stacks == ({"layers", "enc_layers"} if cfg.encoder_layers
                      else {"layers"})
    assert set(want.values()) == {"col", "row"}
    for got in ranks.run("family_kinds", params=params):
        kinds = {}
        for path, kind in got["kinds"]:
            kinds.setdefault(re.sub(r"\[\d+\]", "", path), set()).add(kind)
        assert kinds == {p: {k} for p, k in want.items()}
        assert got["replicated"] == []
        if cfg.vision_tokens:
            assert got["floats"]["vproj_dh"] == [cfg.vision_dim, cfg.d_model]


def test_family_plan_dir_round_trip_on_a_mesh(ranks, tmp_path):
    """whisper on the 2x2 mesh with ``plan_dir``: the first serve programs
    and saves the stamped plans (``enc_layers`` and ``xattn`` among them),
    the second restores them; both give the single-process tokens, and
    ``load_plans(mesh=)`` restores the saved kinds."""
    arch = "whisper-medium"
    want = t_serve.serve(arch, **FAMILY_SERVE)["generated"].tolist()
    kwargs = dict(FAMILY_SERVE, arch=arch, mesh="2,2",
                  plan_dir=str(tmp_path / "plans"))
    replies = ranks.run("serve_plan_dir", kwargs=kwargs)
    said = [run["said"] for run in replies[0]["runs"]]
    assert "saved programmed plans" in said[0], said[0]
    assert "restored programmed plans" in said[1], said[1]
    for got in replies:
        assert [run["generated"] for run in got["runs"]] == [want, want]
        assert got["extras_mesh"] == "2,2"
        kinds = {re.sub(r"\[\d+\]", "", p): k for p, k in got["kinds"]}
        for stack in ("layers", "enc_layers"):
            assert kinds[f"{stack}/attn/wq_dh"] == "col"
            assert kinds[f"{stack}/mlp/wo_hd"] == "row"
        assert kinds["layers/xattn/wk_dh"] == "col"
        assert kinds["layers/xattn/wo_hd"] == "row"


def test_mesh_needs_its_ranks():
    """A mesh larger than the world raises naming the launch command;
    one of the world's size runs in one process."""
    with pytest.raises(ValueError, match="torchrun --standalone "
                                         "--nproc-per-node 2"):
        launch_mesh.make_serve_mesh("1,2", "cpu")
    with pytest.raises(ValueError, match="torchrun"):
        t_serve.serve_continuous(mesh="1,2", **SERVE)
    mesh = launch_mesh.make_serve_mesh("1,1", "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("model") is None


def _jax_names(arch, layers, d_model):
    cfg = j_get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                     vocab=64)
    params = jax.eval_shape(lambda: j_lm.init_lm(cfg,
                                                 jax.random.PRNGKey(0)))
    paths = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        paths.append(("/".join(keys), leaf.ndim))
    return paths


def test_rules_match_the_reference():
    """``logical_rules``, ``param_spec_for_path`` and ``_kind_from_rules``
    equal JAX's for every parameter of reduced qwen3-4b and
    moonshot-v1-16b-a3b."""
    j_mesh_obj = jax.make_mesh((1, 1), ("data", "model"))
    t_mesh_obj = launch_mesh.make_serve_mesh("1,1", "cpu")
    j_rules = j_sharding.logical_rules(j_mesh_obj)
    t_rules = sharding.logical_rules(t_mesh_obj)
    assert {k: tuple(v) for k, v in t_rules.items()} == \
        {k: tuple(v) for k, v in j_rules.items()}
    seen = 0
    for arch in ("qwen3-4b", "moonshot-v1-16b-a3b"):
        for path, ndim in _jax_names(arch, 2, 32):
            name = path.split("/")[-1]
            assert tuple(sharding.param_spec_for_path(path, t_rules)) == \
                tuple(j_sharding.param_spec_for_path(path, j_rules)), path
            expert = name.endswith(("_edf", "_efd")) and ndim >= 3
            assert t_mesh._kind_from_rules(name, t_mesh_obj, expert) == \
                j_mesh._kind_from_rules(name, j_mesh_obj, expert), path
            seen += 1
    assert seen > 20
    with sharding.use_sharding(sharding.ShardingContext(t_mesh_obj)):
        assert sharding.mesh_axis_size("model") == 1
