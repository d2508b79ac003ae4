"""The encoder-decoder (whisper) and the VLM prefix (paligemma) on the
card, at reduced sizes (2 layers of each stack, d_model 256, vocab 512;
paligemma's 16 stub patches of dim 32): serving on ``exact-cuda`` plans
through the PIM matmul kernel equals ``exact-torch`` bit for bit, and
training at ``attn_backend="cuda"`` reaches the flash kernels' non-causal
(whisper's encoder) and prefix-LM (paligemma's decoder) branches. Every
test needs an NVIDIA GPU and nvcc and skips without them; this file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_families.py

Tolerances: served logits and tokens bit for bit (integer plane products,
the same float epilogue and glue); the training loss within rtol 1e-5 of
the "jnp" route and each gradient leaf within 1e-3 of that leaf's largest
magnitude (the flash backward's bound in ``test_torch_cuda_flash.py``:
float32 sums in another order through the recomputed probabilities).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.pim import PimConfig
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.pim_matmul import pim_matmul as pkern
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.tree import leaves

pytestmark = pytest.mark.cuda

FAMILIES = ("whisper-medium", "paligemma-3b")
BWD_REL = 1e-3
# B1 launches per prefill and per decode step and layer pair: whisper's
# encoder layer (q, k, v, o, MLP up and down) and decoder layer (self- and
# cross-attention's q, k, v, o, MLP up and down; a decode step projects
# only the cross-attention's q and o: its K/V are cached); paligemma's
# layer (q, k, v, o, gate, up, down)
B1_PER_LAYER = {"whisper-medium": (6 + 10, 8), "paligemma-3b": (7, 7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch):
    return get_config(arch).reduced(num_layers=2, d_model=256, vocab=512)


def _restamp(tree, substrate):
    if isinstance(tree, dict):
        return {k: _restamp(v, substrate) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dataclasses.replace(p, cfg=dataclasses.replace(
            p.cfg, substrate=substrate)) for p in tree]
    return tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_served_exact_cuda_equals_exact_torch(cuda, arch):
    """The static loop on the card: prefill logits and tokens equal on
    both exact substrates, and the PIM kernel's launches are what the
    layers imply."""
    cfg = _cfg(arch)
    planned = serve._program(cfg, PimConfig(weight_bits=4, act_bits=4,
                                            substrate="exact-cuda"), cuda)
    tokens, inputs = serve.request_inputs(cfg, 4, 40, cuda)
    gen = 6
    pkern.reset_launches()
    generated, _, _, logits = serve.static_loop(planned, cfg, tokens, gen,
                                                inputs=inputs)
    torch.cuda.synchronize()
    pre, step = B1_PER_LAYER[arch]
    assert pkern.LAUNCHES["pim_matmul_fused"] == \
        cfg.num_layers * (pre + gen * step)
    want_gen, _, _, want_logits = serve.static_loop(
        _restamp(planned, "exact-torch"), cfg, tokens, gen, inputs=inputs)
    assert torch.equal(logits, want_logits)
    assert torch.equal(generated, want_gen)
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_flash_branches_against_jnp(cuda, arch):
    """The loss and every gradient leaf at ``attn_backend="cuda"`` against
    "jnp" on one state, and the flash launches by mask branch: whisper's
    encoder layers non-causal, its decoder layers causal; paligemma's
    layers prefix-LM."""
    cfg = dataclasses.replace(_cfg(arch), attn_backend="cuda")
    batch = train.batch_to_device(lm_batch(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=96, global_batch=2),
        cfg, 0), cuda)
    params = lm.init_lm(cfg, 0, device=cuda)
    loss_j, _, grads_j = train.loss_and_grads(
        params, dataclasses.replace(cfg, attn_backend="jnp"), batch)
    fkern.reset_launches()
    loss, _, grads = train.loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, loss_j, rtol=1e-5, atol=0)
    for got, want in zip(leaves(grads), leaves(grads_j)):
        gap = (got - want).abs().max().item()
        assert gap <= BWD_REL * max(want.abs().max().item(), 1e-30), gap
    n = cfg.num_layers
    if cfg.encoder_layers:
        branches = {"non_causal": cfg.encoder_layers, "causal": n}
    else:
        branches = {"prefix_lm": n}
    masked = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")
    assert fkern.BRANCH_LAUNCHES == {(p, b): c for p in masked
                                     for b, c in branches.items()}
    heads_sum = n if cfg.num_heads > cfg.num_kv_heads else 0
    assert fkern.LAUNCHES["flash_attention_bwd_sum"] == heads_sum
