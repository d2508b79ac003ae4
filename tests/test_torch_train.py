"""Training parity: the port's data pipeline, gradient compression, AdamW
schedule, train step and checkpoints against the JAX package, on reduced
gemma3-1b (2 layers, d_model 64, vocab 512, batch 2, seq 64), and the
port's own restart continuity and CLI.

The port's train step runs ``attn_backend="pallas"``: on the CPU the
flash route's plain version; JAX's jitted step runs ``full_attention``.
Both start from one state, JAX's ``init_state`` carried over by
``convert.train_state_from_reference``.

Tolerances, stated per test:
- data batches, compression codes, scales and residuals, the learning
  rate, checkpoint payloads and fingerprints: bit for bit;
- loss and gradient norm: rtol 1e-5 (float32 sums in another order;
  observed below 3e-6);
- parameters after 1 and 3 AdamW steps: every element within atol 1e-4
  and at most 1e-4 of the elements beyond 1e-6. An element whose gradient
  is near zero (comparable to eps = 1e-8) moves by a different fraction
  of an Adam step when its gradient differs in the last bits, and with
  int8 compression a near-tie code may round the other way; one step
  moves an element by at most about lr = 3e-4. Observed: at most 8 of
  201,088 elements beyond 1e-6, the largest gap 3.3e-5.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs.base import get_config as j_get_config
from repro.data import pipeline as j_data
from repro.launch import train as j_train
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro_torch import convert
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as t_data
from repro_torch.launch import train as t_train
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
SCALAR = dict(rtol=1e-5)
PARAM_ATOL, PARAM_FINE, PARAM_SHARE = 1e-4, 1e-6, 1e-4
OPT = dict(lr=3e-4, total_steps=10, warmup_steps=2)


def _cfgs():
    jcfg = j_get_config("gemma3-1b").reduced(num_layers=2, d_model=64,
                                             vocab=512)
    tcfg = dataclasses.replace(convert.model_config_from_reference(jcfg),
                               attn_backend="pallas")
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_lm_batch_bit_identical():
    jcfg, tcfg = _cfgs()
    kw = dict(seed=3, vocab_size=512, seq_len=64, global_batch=4)
    jit = j_data.LMDataIterator(j_data.DataConfig(**kw), jcfg)
    tit = t_data.LMDataIterator(t_data.DataConfig(**kw), tcfg)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb) == ["targets", "tokens"]
        for key in jb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])
    assert tit.state() == jit.state() == 3


def test_compress_grads_bit_identical():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((33, 17)).astype(np.float32),
             "b": {"c": (rng.standard_normal((64,)) * 1e-3).astype(
                 np.float32), "z": np.zeros((5,), np.float32)}}
    err = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-4)
                       .astype(np.float32), grads)
    for e in (None, err):
        jc, js, je = j_comp.compress_grads(
            jax.tree.map(jnp.asarray, grads),
            None if e is None else jax.tree.map(jnp.asarray, e), 8)
        tc, ts, te = t_comp.compress_grads(
            convert.params_from_reference(grads, "cpu"),
            None if e is None else convert.params_from_reference(e, "cpu"),
            8)
        for want, got in ((jc, tc), (js, ts), (je, te)):
            for w, g in zip(jax.tree.leaves(want), leaves(got)):
                assert g.numpy().dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for w, g in zip(jax.tree.leaves(j_comp.decompress_grads(jc, js)),
                        leaves(t_comp.decompress_grads(tc, ts))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_bit_identical(schedule):
    for step in (0, 1, 2, 5, 9, 10, 12):
        jl = j_adamw.schedule_lr(j_adamw.AdamWConfig(schedule=schedule,
                                                     **OPT),
                                 jnp.asarray(step, jnp.int32))
        tl = t_adamw.schedule_lr(t_adamw.AdamWConfig(schedule=schedule,
                                                     **OPT),
                                 torch.tensor(step, dtype=torch.int32))
        assert tl.dtype == torch.float32
        assert float(tl) == float(jl)


def _assert_params_close(jparams, tparams):
    fine = total = 0
    for w, g in zip(jax.tree.leaves(jparams), leaves(tparams)):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= PARAM_ATOL, diff.max()
        fine += int((diff > PARAM_FINE).sum())
        total += diff.size
    assert fine <= PARAM_SHARE * total, (fine, total)


@pytest.mark.parametrize("compress_bits", [0, 8])
def test_train_steps_match_jax(compress_bits):
    """One and three steps from one converted state: loss, gradient norm
    and lr of every step, and the parameters after steps 1 and 3."""
    jcfg, tcfg = _cfgs()
    jst = j_train.init_state(jcfg, jax.random.PRNGKey(0))
    if compress_bits:
        jst["grad_err"] = j_comp.init_error_state(jst["params"])
    tst = convert.train_state_from_reference(_np_tree(jst), "cpu")
    assert t_ckpt.tree_fingerprint(tst) == j_ckpt.tree_fingerprint(jst)
    jstep = jax.jit(j_train.make_train_step(jcfg, j_adamw.AdamWConfig(**OPT),
                                            compress_bits))
    tstep = t_train.make_train_step(tcfg, t_adamw.AdamWConfig(**OPT),
                                    compress_bits)
    dcfg = j_data.DataConfig(vocab_size=512, seq_len=64, global_batch=2)
    for i in range(3):
        batch = j_data.lm_batch(dcfg, jcfg, i)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tm = tstep(tst, t_train.batch_to_device(batch, "cpu"))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **SCALAR)
        assert float(tm["lr"]) == float(jm["lr"])
        assert tst["step"].shape == () and tst["step"].dtype == torch.int32
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert int(tst["opt"].step) == i + 1
        if i in (0, 2):
            _assert_params_close(jst["params"], tst["params"])


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written checkpoint restores in the port, and the reverse:
    equal fingerprints, verified sha256, equal leaves (a bf16 leaf
    crosses as its bits)."""
    jcfg, _ = _cfgs()
    jst = j_train.init_state(jcfg, jax.random.PRNGKey(1))
    jst["grad_err"] = j_comp.init_error_state(jst["params"])
    jst["params"]["embed_vd"] = jst["params"]["embed_vd"].astype(
        jnp.bfloat16)
    tst = convert.train_state_from_reference(_np_tree(jst), "cpu")
    assert tst["params"]["embed_vd"].dtype == torch.bfloat16
    assert t_ckpt.tree_fingerprint(tst) == j_ckpt.tree_fingerprint(jst)

    j_ckpt.save_checkpoint(str(tmp_path / "j"), 7, jst, {"data_step": 7})
    zeros = convert.train_state_from_reference(
        _np_tree(jax.tree.map(jnp.zeros_like, jst)), "cpu")
    got, step, extras = t_ckpt.restore_checkpoint(str(tmp_path / "j"), zeros)
    assert (step, extras) == (7, {"data_step": 7})
    for w, g in zip(jax.tree.leaves(jst), leaves(got)):
        assert (g.dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))

    t_ckpt.save_checkpoint(str(tmp_path / "t"), 9, tst, {"data_step": 9})
    jgot, step, extras = j_ckpt.restore_checkpoint(
        str(tmp_path / "t"), jax.tree.map(jnp.zeros_like, jst))
    assert (step, extras) == (9, {"data_step": 9})
    for w, g in zip(jax.tree.leaves(jst), jax.tree.leaves(jgot)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))

    # a flipped payload byte is caught by the sha256 check
    path = tmp_path / "t" / "step_00000009" / "arrays.npz"
    import zipfile
    with zipfile.ZipFile(path) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    name = "leaf_00003.npy"
    raw = bytearray(members[name])
    raw[-1] ^= 0xFF
    members[name] = bytes(raw)
    with zipfile.ZipFile(path, "w") as zf:
        for n, data in members.items():
            zf.writestr(n, data)
    with pytest.raises(t_ckpt.CheckpointCorruptionError) as ei:
        t_ckpt.restore_checkpoint(str(tmp_path / "t"), zeros)
    assert ei.value.leaf_index == 3
    renamed = {("steps" if k == "step" else k): v for k, v in zeros.items()}
    with pytest.raises(ValueError, match="structure mismatch"):
        t_ckpt.restore_checkpoint(str(tmp_path / "j"), renamed)


def test_remat_keeps_loss_and_gradients():
    """cfg.remat checkpoints each layer (torch.utils.checkpoint): the
    recomputed forward repeats the same arithmetic, so loss and gradients
    are equal bit for bit."""
    _, tcfg = _cfgs()
    params = t_train.init_state(tcfg, 0, device="cpu")["params"]
    batch = t_train.batch_to_device(j_data.lm_batch(
        j_data.DataConfig(vocab_size=512, seq_len=64, global_batch=2),
        tcfg, 0), "cpu")
    loss, _, grads = t_train.loss_and_grads(params, tcfg, batch)
    loss_r, _, grads_r = t_train.loss_and_grads(
        params, dataclasses.replace(tcfg, remat=True), batch)
    assert float(loss_r) == float(loss)
    for g, r in zip(leaves(grads), leaves(grads_r)):
        torch.testing.assert_close(r, g, rtol=0, atol=0)


def test_train_checkpoint_restart_continuity(tmp_path):
    """Interrupt + resume == uninterrupted run (same data, same state), as
    tests/test_system.py holds the JAX package."""
    d = str(tmp_path / "ck")
    kw = dict(batch=2, seq=32, layers=1, d_model=32, log_every=1,
              device="cpu")
    t_train.train_loop("qwen3-4b", steps=6, ckpt_dir=d, ckpt_every=3, **kw)
    assert t_ckpt.latest_step(d) == 6
    resumed = t_train.train_loop("qwen3-4b", steps=10, ckpt_dir=d,
                                 ckpt_every=100, **kw)
    straight = t_train.train_loop("qwen3-4b", steps=10, **kw)
    assert abs(resumed["last_loss"] - straight["last_loss"]) < 5e-2
    # resumed from the unbroken run's own step-6 checkpoint, under the
    # same schedule, the run repeats the same arithmetic exactly
    d2 = str(tmp_path / "ck2")
    t_train.train_loop("qwen3-4b", steps=10, ckpt_dir=d2, ckpt_every=6, **kw)
    again = t_train.train_loop("qwen3-4b", steps=10, ckpt_dir=d2,
                               ckpt_every=100, **kw)
    assert again["last_loss"] == straight["last_loss"]


def test_train_loss_decreases_with_compression_and_flash_route():
    res = t_train.train_loop("gemma3-1b", steps=20, batch=4, seq=64,
                             layers=2, d_model=64, compress_bits=8,
                             log_every=5, device="cpu",
                             attn_backend="cuda")
    assert res["last_loss"] < res["first_loss"]


def test_train_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--layers", "2", "--d-model", "64", "--device", "cpu",
         "--steps", "3", "--seq", "64", "--batch", "2", "--attn-backend",
         "pallas"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] loss" in res.stdout


def test_attn_backend_default_and_clip_match_jax():
    """The config default stays "jnp", as in JAX; clip_by_global_norm
    equals JAX's within rtol 1e-6 (float32 sums in another order)."""
    assert get_config("gemma3-1b").attn_backend == "jnp"
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((40, 3)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32)]}
    for max_norm in (0.5, 100.0):
        jt, jn = j_adamw.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        tt, tn = t_adamw.clip_by_global_norm(
            convert.params_from_reference(tree, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for w, g in zip(jax.tree.leaves(jt), leaves(tt)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
