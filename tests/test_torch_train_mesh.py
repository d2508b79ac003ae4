"""Sharded training in the port (``repro_torch.launch.train`` on a mesh:
``fit_spec`` / ``param_shardings`` / ``state_shardings`` /
``batch_shardings``, ``shard_state`` / ``gather_state``,
``make_train_step(..., mesh=)``, vocab-parallel cross-entropy, the
split-aware clip and compression, mesh checkpoints, ``--mesh``).

One gloo group of 4 ranks on the CPU, spawned once for the file
(``torch_mesh_worker.py`` holds the rank side), runs each sharded step
from a state JAX's ``init_state`` drew, converted; this process runs the
port's single-process step from the same state and the JAX side (the spec
tables, and one case's loss through JAX's own step). The JAX package's
own sharded step does not run on this host (``tests/test_distributed.py``),
so the sharded step is held to the port's single-process step, which
``tests/test_torch_train.py`` holds to JAX.

Tolerances, stated per test:
- spec tables, compression codes and scales, checkpoint leaves,
  replicated leaves across ranks: bit for bit;
- loss and gradient norm: rtol 1e-5 (float32 sums in another order:
  the blocks of a split matmul, the data ranks' means);
- every gathered gradient leaf: within 1e-4 of the leaf's largest
  magnitude;
- parameters after one AdamW step: within 5e-3, the JAX package's bound
  for its sharded step (an element whose gradient is near zero moves by a
  different fraction of an Adam step when the gradient differs in its
  last bits).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as j_get_config
from repro.launch import train as j_train
from repro.optim import adamw as j_adamw
from repro_torch import convert
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.data import pipeline as t_data
from repro_torch.launch import train as t_train
from repro_torch.optim import adamw as t_adamw
from repro_torch.tree import flatten_with_path, leaves

from test_torch_mesh import Ranks

ROOT = Path(__file__).resolve().parents[1]
SCALAR = dict(rtol=1e-5)
GRAD_REL, PARAM_ATOL = 1e-4, 5e-3
OPT = dict(lr=3e-4, total_steps=10, warmup_steps=2)
BATCH, SEQ = 4, 32
ARCHS = ("qwen3-4b", "gemma3-1b", "moonshot-v1-16b-a3b", "hymba-1.5b",
         "whisper-medium", "paligemma-3b")
# (arch, mesh): every config on 2x2, and each on a 1x4 or 4x1 mesh
CASES = [(a, "2,2") for a in ARCHS] + [
    ("qwen3-4b", "1,4"), ("gemma3-1b", "1,4"),
    ("moonshot-v1-16b-a3b", "4,1"), ("hymba-1.5b", "1,4"),
    ("whisper-medium", "1,4"), ("paligemma-3b", "4,1")]
# the flash route (its plain version here): gemma3-1b's sliding windows,
# whisper's non-causal encoder and causal decoder, paligemma's prefix-LM
FLASH_ARCHS = ("gemma3-1b", "whisper-medium", "paligemma-3b")


def _jcfg(arch):
    """The reduced configs: qwen3-4b as the JAX sharded-step test reduces
    it; gemma3-1b (one KV head, sliding windows, a tied vocab) on the
    flash route; moonshot (8 experts, shared experts) for the expert
    split and the router losses; hymba for the SSM's projections; whisper
    (2 encoder layers, cross-attention over 4 heads) and paligemma (16
    stub patches through ``vproj_dh``, one KV head) on the flash route."""
    if arch == "qwen3-4b":
        cfg = j_get_config(arch).reduced(num_layers=2, d_model=64,
                                         vocab=256)
        return dataclasses.replace(cfg, d_ff=256)
    return j_get_config(arch).reduced(num_layers=2, d_model=64, vocab=512)


def _tcfg(arch):
    cfg = convert.model_config_from_reference(_jcfg(arch))
    if arch in FLASH_ARCHS:
        cfg = dataclasses.replace(cfg, attn_backend="pallas")
    return cfg


_STATES = {}


def _jax_state(arch):
    if arch not in _STATES:
        _STATES[arch] = jax.tree.map(np.asarray, j_train.init_state(
            _jcfg(arch), jax.random.PRNGKey(0)))
    return _STATES[arch]


def _state(arch):
    """A fresh port state converted from JAX's (steps update in place)."""
    return convert.train_state_from_reference(_jax_state(arch), "cpu")


def _batch(arch):
    cfg = _tcfg(arch)
    return t_data.lm_batch(t_data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH), cfg, 0)


def _named(tree):
    return {"/".join(path): t for path, t in flatten_with_path(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = Ranks(tmp_path_factory.mktemp("train_mesh"))
    try:
        yield group
    finally:
        group.close()
    assert not any(p.is_alive() for p in group.procs)


# ---------------------------------------------------------------------------
# the spec tables against JAX's
# ---------------------------------------------------------------------------
class ShapeMesh:
    """The axes and sizes of a mesh, which is all the spec tables read."""

    def __init__(self, shape, axis_names=("data", "model")):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))


def _norm(spec):
    """A spec's entries with one-name tuples as the name, as both packages
    read them."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else (e or None) if isinstance(e, tuple) else e
                 for e in tuple(spec))


def _spec_leaves(tree):
    """The specs of a spec tree (dicts of specs) in flatten order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def _padded(spec, ndim):
    return _norm(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tables_match_jax(arch, shape):
    """``param_shardings``, ``state_shardings`` and ``batch_shardings``
    give, leaf by leaf, JAX's specs for the same tree and mesh shape."""
    jmesh = AbstractMesh(shape, ("data", "model"))
    tmesh = ShapeMesh(shape)
    jstate = jax.eval_shape(lambda: j_train.init_state(
        _jcfg(arch), jax.random.PRNGKey(0)))
    want = jax.tree.leaves(j_train.state_shardings(jmesh, jstate))
    tstate = t_train.state_template(_tcfg(arch))
    got = t_train.tree_specs(tmesh, tstate)
    shapes = [tuple(x.shape) for x in jax.tree.leaves(jstate)]
    assert [tuple(x.shape) for x in leaves(tstate)] == shapes
    assert [_norm(g) for g in got] == [_padded(w.spec, len(s))
                                       for w, s in zip(want, shapes)]
    jps = j_train.param_shardings(jmesh, jstate["params"])
    ps = t_train.param_shardings(tmesh, tstate["params"])
    assert [_norm(s) for s in _spec_leaves(ps)] == [
        _padded(w.spec, len(x.shape)) for w, x in zip(
            jax.tree.leaves(jps), jax.tree.leaves(jstate["params"]))]
    st = t_train.state_shardings(tmesh, tstate)
    assert st["opt"].mu is st["params"] and st["opt"].nu is st["params"]
    assert tuple(st["step"]) == () and tuple(st["opt"].step) == ()
    cfg = _jcfg(arch)
    for b in (BATCH, 3):
        batch = {"tokens": np.zeros((b, SEQ), np.int32),
                 "targets": np.zeros((b, SEQ), np.int32)}
        if cfg.vision_tokens:
            batch["patches"] = np.zeros(
                (b, cfg.vision_tokens, cfg.vision_dim), np.float32)
        if cfg.encoder_layers:
            batch["frames"] = np.zeros((b, SEQ, cfg.d_model), np.float32)
        jb = j_train.batch_shardings(jmesh, batch)
        tb = t_train.batch_shardings(tmesh, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        for k, v in batch.items():
            assert _norm(tb[k]) == _padded(jb[k].spec, v.ndim), (k, b)


@pytest.mark.parametrize("shape,spec,dims", [
    ((1,), ("model",), (7,)),           # a one-rank axis divides anything
    ((2, 2), ("model",), (7,)),
    ((2, 2), (None, "model"), (64, 6)),
    ((2, 2), (("data", "model"),), (8,)),
    ((2, 2), (("data", "model"),), (6,)),
    ((4, 1), ("data", "model"), (3, 5)),
])
def test_fit_spec_matches_jax(shape, spec, dims):
    from jax.sharding import PartitionSpec as JP
    from repro_torch.distributed.sharding import PartitionSpec as TP
    names = ("model",) if len(shape) == 1 else ("data", "model")
    want = j_train.fit_spec(AbstractMesh(shape, names), JP(*spec), dims)
    got = t_train.fit_spec(ShapeMesh(shape, names), TP(*spec), dims)
    assert _norm(got) == _padded(want, len(dims))


# ---------------------------------------------------------------------------
# the sharded step against the single-process step
# ---------------------------------------------------------------------------
def _single(arch, batch):
    """The port's single-process loss, gradient norm and gradient, and one
    step's metrics and parameters, from the converted state."""
    cfg = _tcfg(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = _state(arch)
    loss, metrics, grads = t_train.loss_and_grads(state["params"], cfg, tb)
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(t_adamw.global_norm(grads)),
           "grads": {k: v.numpy() for k, v in _named(grads).items()}}
    state, m = t_train.make_train_step(cfg, t_adamw.AdamWConfig(**OPT))(
        state, tb)
    out.update(step_loss=float(m["loss"]),
               step_grad_norm=float(m["grad_norm"]),
               params={k: v.numpy() for k, v in
                       _named(state["params"]).items()})
    return out


@pytest.mark.parametrize("arch,spec", CASES)
def test_sharded_step_matches_single_process(ranks, arch, spec):
    """Loss and gradient norm (of the loss-and-gradients pass and of the
    train step), each gathered gradient leaf, the parameters after one
    AdamW step; replicated leaves bit-identical on every rank."""
    batch = _batch(arch)
    want = _single(arch, batch)
    replies = ranks.run("train_mesh_step", cfg=_tcfg(arch),
                        state=_state(arch), batch=batch, opt=OPT, spec=spec)
    dp, tp = map(int, spec.split(","))
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in replies) == [(d, m) for d in range(dp)
                                        for m in range(tp)]
    first = replies[0]
    assert any(first["split"].values()) == (tp > 1)
    for got in replies:
        assert got["backend"] == "gloo" and got["step"] == 1
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], **SCALAR)
            np.testing.assert_allclose(got["step_" + key],
                                       want["step_" + key], **SCALAR)
        for name, g in want["grads"].items():
            gap = np.abs(got["grads"][name] - g).max()
            assert gap <= GRAD_REL * max(np.abs(g).max(), 1e-30), (name,
                                                                   gap)
        for name, p in want["params"].items():
            assert got["params"][name].shape == p.shape
            assert np.abs(got["params"][name] - p).max() <= PARAM_ATOL, name
        assert sorted(got["replicated"]) == sorted(
            k for k, s in first["split"].items() if not s)
        for name, leaf in got["replicated"].items():
            np.testing.assert_array_equal(leaf, first["replicated"][name])


REPEATS = 5


def test_sharded_step_repeats(ranks):
    """moonshot's 4x1 step, repeated in the one group: every repeat holds
    the single-process step as the test above does, and no rank writes
    into the state it was handed (a request's tensors reach the ranks in
    storage shared with this process and with each other, so a rank that
    updated them in place would update every rank's copy)."""
    arch, spec = "moonshot-v1-16b-a3b", "4,1"
    batch = _batch(arch)
    want = _single(arch, batch)
    pristine = leaves(_state(arch))
    for repeat in range(REPEATS):
        state = _state(arch)
        replies = ranks.run("train_mesh_step", cfg=_tcfg(arch), state=state,
                            batch=batch, opt=OPT, spec=spec)
        for a, b in zip(leaves(state), pristine):
            assert torch.equal(a, b), repeat
        for got in replies:
            np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                       **SCALAR)
            for name, p in want["params"].items():
                gap = np.abs(got["params"][name] - p).max()
                assert gap <= PARAM_ATOL, (repeat, name, gap)


def test_sharded_loss_matches_jax(ranks):
    """The 2x2 step's loss against JAX's own jitted step on that state."""
    arch = "qwen3-4b"
    batch = _batch(arch)
    jstate = jax.tree.map(jnp.asarray, _jax_state(arch))
    jstep = jax.jit(j_train.make_train_step(_jcfg(arch),
                                            j_adamw.AdamWConfig(**OPT)))
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    replies = ranks.run("train_mesh_step", cfg=_tcfg(arch),
                        state=_state(arch), batch=batch, opt=OPT,
                        spec="2,2")
    for got in replies:
        np.testing.assert_allclose(got["step_loss"], float(jm["loss"]),
                                   **SCALAR)
        np.testing.assert_allclose(got["step_grad_norm"],
                                   float(jm["grad_norm"]), **SCALAR)


@pytest.mark.parametrize("arch", ("gemma3-1b", "moonshot-v1-16b-a3b"))
def test_compression_codes_bit_exact(ranks, arch):
    """int8 codes of every split leaf, gathered, equal ``compress_leaf`` of
    the gathered gradient bit for bit (the scale is the whole leaf's
    max)."""
    for cases in ranks.run("train_compress_codes", cfg=_tcfg(arch),
                           state=_state(arch), batch=_batch(arch),
                           spec="2,2"):
        assert cases and all(cases.values()), cases


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_mesh_checkpoint_restores_in_one_process(ranks, tmp_path):
    """A checkpoint saved on the 2x2 mesh holds the global leaves: one
    process restores it bit for bit, under JAX's fingerprint."""
    arch = "gemma3-1b"
    paths = ranks.run("train_save", cfg=_tcfg(arch), state=_state(arch),
                      directory=str(tmp_path / "mesh"), spec="2,2")
    assert len(set(paths)) == 1
    want = _state(arch)
    got, step, extras = t_ckpt.restore_checkpoint(
        str(tmp_path / "mesh"), convert.train_state_from_reference(
            jax.tree.map(np.zeros_like, _jax_state(arch)), "cpu"))
    assert (step, extras) == (3, {"data_step": 3})
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def test_single_checkpoint_restores_on_the_mesh(ranks, tmp_path):
    """A single-process checkpoint restores onto the 2x2 and the 1x4 mesh,
    each rank's slices bit for bit."""
    arch = "moonshot-v1-16b-a3b"
    t_ckpt.save_checkpoint(str(tmp_path), 5, _state(arch))
    for spec in ("2,2", "1,4"):
        for step, equal in ranks.run("train_restore", cfg=_tcfg(arch),
                                     state=_state(arch),
                                     directory=str(tmp_path), spec=spec):
            assert step == 5 and equal, spec


def test_failed_mesh_save_raises_on_every_rank(ranks, tmp_path):
    """Rank 0 cannot write (its directory is a file): every rank raises."""
    blocked = tmp_path / "file"
    blocked.write_text("")
    kinds = ranks.run("train_save_fails", state=_state("gemma3-1b"),
                      directory=str(blocked / "ckpt"), spec="2,2")
    assert all(kinds), kinds
    assert all(k == "OSError" for k in kinds[1:]), kinds


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def test_mesh_needs_its_ranks():
    """``--mesh`` larger than the world raises naming the torchrun line."""
    with pytest.raises(ValueError, match="torchrun --standalone "
                       "--nproc-per-node 2 -m repro_torch.launch.train"):
        t_train.train_loop("gemma3-1b", steps=1, layers=2, d_model=64,
                           device="cpu", mesh="1,2")


def test_cli_trains_on_a_mesh(tmp_path):
    """``torchrun ... -m repro_torch.launch.train --mesh 2,2`` on the CPU
    logs, on rank 0 only, the losses of the single-process run."""
    args = ["--arch", "gemma3-1b", "--layers", "2", "--d-model", "64",
            "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
            "32"]
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args,
         "--mesh", "2,2"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    assert "[train] mesh 2,2 over 4 ranks, backend gloo" in mesh.stdout
    lines = lambda out: [l for l in out.splitlines()
                         if l.startswith("[train] loss")]
    assert len(lines(mesh.stdout)) == 1
    got = [float(x) for x in lines(mesh.stdout)[0].split()[2::2]]
    want = [float(x) for x in lines(one.stdout)[0].split()[2::2]]
    np.testing.assert_allclose(got, want, atol=2e-4)
