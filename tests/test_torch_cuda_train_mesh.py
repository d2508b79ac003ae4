"""Sharded training on the card: two ranks sharing one GPU over gloo
(``repro_torch.launch.mesh`` picks gloo when ranks share a card) train
reduced gemma3-1b (2 layers, d_model 64, vocab 512, ``attn_backend="cuda"``)
on a 1x2 and on a 2x1 mesh through ``make_train_step(..., mesh=)``; each
is held to the single-process step on the card from the same state and
batch, with the tolerances of ``tests/test_torch_train_mesh.py`` (loss and
gradient norm rtol 1e-5, each gathered gradient leaf within 1e-4 of its
largest magnitude, parameters after one AdamW step within 5e-3,
replicated leaves bit-identical across ranks), and each rank launches
every flash kernel once per layer and pass. Every test needs an NVIDIA
GPU and nvcc and skips without them; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_cuda_train_mesh.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import runtime
from repro_torch.launch import train
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_path, tree_map

from test_torch_cuda_mesh import _run_on_ranks

pytestmark = pytest.mark.cuda

OPT = dict(lr=3e-4, total_steps=10, warmup_steps=2)
LAYERS = 2
FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv", "flash_attention_bwd_sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _named(tree):
    return {"/".join(p): t.detach().cpu().numpy()
            for p, t in flatten_with_path(tree)}


@pytest.mark.parametrize("spec", ["1,2", "2,1"])
def test_sharded_step_on_the_card(cuda, tmp_path, spec):
    runtime.build_all(["flash_attention"])        # before any rank
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(
        num_layers=LAYERS, d_model=64, vocab=512), attn_backend="cuda")
    state = train.init_state(cfg, 0, device="cpu")
    batch = pipeline.lm_batch(pipeline.DataConfig(
        vocab_size=512, seq_len=64, global_batch=4), cfg, 0)
    on_card = tree_map(lambda t: t.to(cuda), state)
    tb = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    _, metrics, grads = train.loss_and_grads(on_card["params"], cfg, tb)
    want = {"loss": float(metrics["loss"]),
            "grad_norm": float(adamw.global_norm(grads))}
    want_grads = _named(grads)
    on_card, m = train.make_train_step(cfg, adamw.AdamWConfig(**OPT))(
        on_card, tb)
    want_params = _named(on_card["params"])
    replies = _run_on_ranks(tmp_path, "train_mesh_step", cfg=cfg,
                            state=state, batch=batch, opt=OPT, spec=spec)
    first = replies[0]
    for got in replies:
        assert got["backend"] == "gloo" and got["device"] == "cuda:0"
        assert got["launches"] == dict.fromkeys(FLASH, 2 * LAYERS)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["step_loss"], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["step_grad_norm"],
                                   float(m["grad_norm"]), rtol=1e-5)
        for name, g in want_grads.items():
            gap = np.abs(got["grads"][name] - g).max()
            assert gap <= 1e-4 * max(np.abs(g).max(), 1e-30), (name, gap)
        for name, p in want_params.items():
            assert np.abs(got["params"][name] - p).max() <= 5e-3, name
        for name, leaf in got["replicated"].items():
            np.testing.assert_array_equal(leaf, first["replicated"][name])
