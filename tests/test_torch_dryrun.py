"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

The JAX module sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would change every later test in the process, so its side
runs in one subprocess for this file (:data:`JAX_SIDE`), and only its
numbers come back.

Tolerances:
- ``SHAPES``, ``cell_is_applicable``, ``model_flops``, the shapes and
  dtypes of ``input_specs`` and ``cache_specs`` for every config and shape,
  and every parameter leaf's local shape on the 16x16 and 2x16x16 meshes
  (JAX's ``param_shardings`` on those meshes): equal;
- on reduced configs, the per-rank state bytes equal the bytes of the
  real local tensors of ``shard_state`` / ``init_state(mesh=)`` on every
  rank, and the traced FLOP count equals ``FlopCounterMode`` of the same
  step on real CPU tensors: equal.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.archs import ARCH_IDS
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.launch import dryrun
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]

JAX_SIDE = r"""
import json, sys
import jax
from jax.sharding import AbstractMesh
from repro.configs.archs import ARCH_IDS
from repro.configs.base import get_config
from repro.launch import dryrun, train
from repro.models.lm import init_lm

def spec_of(x):
    return [list(x.shape), str(x.dtype)]

out = {"shapes": dryrun.SHAPES, "cells": {}, "local": {}}
meshes = {"pod": AbstractMesh((16, 16), ("data", "model")),
          "multipod": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for shape in dryrun.SHAPES:
        ok, reason = dryrun.cell_is_applicable(cfg, shape)
        cache = dryrun.cache_specs(cfg, shape)
        out["cells"][f"{arch}|{shape}"] = {
            "applicable": [ok, reason],
            "model_flops": dryrun.model_flops(cfg, shape),
            "inputs": {k: spec_of(v) for k, v in
                       dryrun.input_specs(cfg, shape).items()},
            "cache": {k: spec_of(v) for k, v in cache.items()}}
    tmpl = jax.eval_shape(lambda: init_lm(cfg, jax.random.PRNGKey(0)))
    for name, mesh in meshes.items():
        shards = jax.tree.leaves(train.param_shardings(mesh, tmpl))
        local = []
        for sh, leaf in zip(shards, jax.tree.leaves(tmpl)):
            dims = list(leaf.shape)
            for d, axes in enumerate(tuple(sh.spec)):
                if axes is None:
                    continue
                for a in ((axes,) if isinstance(axes, str) else axes):
                    dims[d] //= mesh.shape[a]
            local.append([list(leaf.shape), dims])
        out["local"][f"{arch}|{name}"] = local
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def _spec(t):
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


def test_pure_functions_match_jax(jax_side):
    assert dryrun.SHAPES == jax_side["shapes"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in dryrun.SHAPES:
            want = jax_side["cells"][f"{arch}|{shape}"]
            assert list(dryrun.cell_is_applicable(cfg, shape)) == \
                want["applicable"], (arch, shape)
            assert dryrun.model_flops(cfg, shape) == want["model_flops"]
            assert {k: _spec(v) for k, v in
                    dryrun.input_specs(cfg, shape).items()} == \
                want["inputs"], (arch, shape)
            assert {k: _spec(v) for k, v in
                    dryrun.cache_specs(cfg, shape).items()} == \
                want["cache"], (arch, shape)


@pytest.mark.parametrize("mesh_kind", ("pod", "multipod"))
def test_local_shapes_match_jax(jax_side, mesh_kind):
    """Every parameter leaf's local shape from the port's spec table on
    the 16x16 and 2x16x16 meshes equals the one JAX's ``param_shardings``
    gives on an ``AbstractMesh`` of the same axes."""
    mesh = dryrun.make_dry_mesh(mesh_kind)
    for arch in ARCH_IDS:
        tmpl = t_train.param_template(get_config(arch))
        got = [[list(t.shape), list(dryrun.local_shape(mesh, s, t.shape))]
               for s, t in zip(t_train.tree_specs(mesh, tmpl),
                               leaves(tmpl))]
        assert got == jax_side["local"][f"{arch}|{mesh_kind}"], arch


def test_roofline_constants_are_the_h100s():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    terms = dryrun.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0,
                     "collective_s": 1.0}
    src = Path(dryrun.__file__).read_text()
    assert src.count("NVIDIA H100 80GB HBM3, 700 W") >= 3


TINY = {"train_tiny": {"seq_len": 32, "global_batch": 4, "kind": "train"},
        "prefill_tiny": {"seq_len": 32, "global_batch": 4,
                         "kind": "prefill"},
        "decode_tiny": {"seq_len": 32, "global_batch": 4,
                        "kind": "decode"}}


def _reduced(arch):
    return get_config(arch).reduced(num_layers=2, d_model=64, vocab=512)


@pytest.mark.parametrize("arch,mesh_kind", [
    ("gemma3-1b", "2,2"), ("moonshot-v1-16b-a3b", "4,1"),
    ("qwen3-4b", "1,4")])
def test_state_bytes_equal_the_real_local_state(monkeypatch, arch,
                                               mesh_kind):
    """``run_cell``'s float32 train state per rank equals the bytes of
    every rank's real local state (``init_state(mesh=)`` on the CPU)."""
    monkeypatch.setitem(dryrun.SHAPES, "train_tiny", TINY["train_tiny"])
    cfg = _reduced(arch)
    res = dryrun.run_cell(arch, "train_tiny", mesh_kind, save=False,
                          verbose=False, cfg=cfg)
    assert res["status"] == "ok", res.get("error")
    if cfg.is_moe:
        assert res["assumed"] == dryrun.MOE_ASSUMPTION
    want = res["bytes_per_rank"]["state_f32"]
    mesh = dryrun.make_dry_mesh(mesh_kind)
    for rank in range(mesh.ranks):
        rmesh = dryrun.DryMesh(list(mesh.shape.values()), mesh.axis_names,
                               rank)
        state = t_train.init_state(cfg, 0, device="cpu", mesh=rmesh)
        assert sum(t.nbytes for t in leaves(state)) == want, rank


def _real_flops(cfg, shape, mesh):
    """FLOPs of the cell's step on real CPU tensors, as the dry-run runs
    it: the same route, mesh and collectives stand-in."""
    info = TINY[shape]
    cfg = dryrun._run_config(cfg, shape)
    np_batch = lm_batch(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=info["seq_len"],
                                   global_batch=info["global_batch"]), cfg, 0)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    with dryrun.recording_collectives() as log, \
            FlopCounterMode(display=False) as counter:
        if info["kind"] == "train":
            state = t_train.init_state(cfg, 0, device="cpu", mesh=mesh)
            t_train.make_train_step(cfg, AdamWConfig(), mesh=mesh)(state,
                                                                  batch)
        else:
            params = t_lm.init_lm(cfg, 0, device="cpu")
            local = dryrun._batch_block(mesh, {"tokens": batch["tokens"]})
            if info["kind"] == "prefill":
                t_lm.prefill(params, cfg, local, max_len=info["seq_len"])
            else:
                b = local["tokens"].shape[0]
                cache = t_lm.init_cache(cfg, b, info["seq_len"])
                t_lm.decode_step(params, cfg, cache,
                                 local["tokens"][:, :1],
                                 info["seq_len"] - 1)
    return float(counter.get_total_flops()), dict(log)


@pytest.mark.parametrize("shape", sorted(TINY))
@pytest.mark.parametrize("arch,mesh_kind", [("gemma3-1b", "2,2"),
                                            ("hymba-1.5b", "1,2")])
def test_flops_equal_the_real_step(monkeypatch, arch, mesh_kind, shape):
    """The FLOPs and collective bytes traced on meta tensors equal those
    of the same step on real CPU tensors."""
    for name, info in TINY.items():
        monkeypatch.setitem(dryrun.SHAPES, name, info)
    cfg = _reduced(arch)
    mesh = dryrun.make_dry_mesh(mesh_kind)
    flops, coll, route = dryrun.count_step(dryrun._run_config(cfg, shape),
                                           shape, mesh)
    want_flops, want_coll = _real_flops(cfg, shape, mesh)
    assert flops > 0 and flops == want_flops
    assert coll == want_coll
    assert route == ("sharded" if TINY[shape]["kind"] == "train"
                     else "data-parallel")


@pytest.mark.parametrize("arch", ("whisper-medium", "paligemma-3b"))
def test_encoder_decoder_and_vlm_train_sharded(arch):
    """The encoder-decoder's and the VLM's train cells trace the sharded
    step (the encoder stack, cross-attention and the patch projector
    split), say so, log its collectives and are ``ok``."""
    res = dryrun.run_cell(arch, "train_4k", "2,2", save=False,
                          verbose=False, cfg=_reduced(arch))
    assert res["status"] == "ok", res.get("error")
    assert res["flops_route"] == "sharded"
    assert res["collective_total"] > 0


def test_skipped_and_failed_cells(tmp_path, monkeypatch):
    """A full-attention arch skips long_500k as JAX's does; a cell whose
    spec does not divide reports FAILED with its error and does not
    raise; results land in the result directory."""
    monkeypatch.setattr(dryrun, "RESULT_DIR", str(tmp_path))
    res = dryrun.run_cell("qwen3-4b", "long_500k", "pod", verbose=False)
    assert res["status"] == "skipped"
    assert json.loads((tmp_path / "qwen3-4b__long_500k__pod.json")
                      .read_text())["status"] == "skipped"
    monkeypatch.setattr(dryrun, "rank_bytes", lambda *a: (_ for _ in ())
                        .throw(ValueError("does not divide")))
    res = dryrun.run_cell("qwen3-4b", "train_4k", "3,5", verbose=False,
                          cfg=_reduced("qwen3-4b"))
    assert res["status"] == "FAILED" and "does not divide" in res["error"]
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.local_shape(dryrun.make_dry_mesh("1,3"),
                           dryrun.P(None, "model"), (4, 64))
    assert math.isclose(dryrun.roofline_terms(2.0, 0.0, 0.0, 2)[
        "compute_s"], 1.0 / dryrun.PEAK_FLOPS)
