"""Flash-attention parity: the port's flash route (``kernels/flash_attention``,
which on CPU tensors runs its plain version) against the JAX package's
Pallas kernel in interpret mode and its reference, forward and gradients;
the attention block's dispatch; and the port's ``lm.forward`` with
``attn_backend="pallas"`` on reduced gemma3-1b against JAX's ``lm.forward``
(which runs ``full_attention``: its scanned window never meets the flash
guard); and the plain versions of the three backward kernels against
autograd. Inputs are seeded numpy arrays handed to both packages.

Tolerances, stated per test:
- forward in float32: rtol 2e-4, atol 2e-5 (the JAX kernel test's bound
  between its Pallas kernel and its reference);
- forward in bfloat16: rtol 3e-2, atol 3e-2 (the JAX bf16 test's bound);
- gradients: rtol 1e-4, atol 1e-5 (float32 autograd through the same
  formula, sums in another order; observed gaps are near 1e-7);
- the attention block and whole-model logits: rtol 1e-4, atol 1e-5, as
  in ``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro_torch import convert
from repro_torch.kernels.flash_attention import flash_attention as t_kern
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm

KERNEL = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
GRAD = dict(rtol=1e-4, atol=1e-5)
MATMUL = dict(rtol=1e-4, atol=1e-5)
# the cases of tests/test_kernels.py::test_flash_attention_kernel
CASES = [
    (2, 128, 4, 2, 32, True, 0, 0),
    (1, 128, 8, 1, 16, True, 0, 0),      # MQA
    (2, 64, 4, 4, 32, False, 0, 0),      # bidirectional (encoder)
    (1, 128, 4, 2, 16, True, 40, 0),     # sliding window
    (1, 128, 4, 2, 16, True, 0, 24),     # prefix-LM
    (1, 128, 4, 2, 16, True, 24, 16),    # window + prefix
]


def _qkv(b, s, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("b,s,h,kv,d,causal,win,pre", CASES)
def test_flash_forward_matches_pallas_and_reference(b, s, h, kv, d, causal,
                                                    win, pre):
    q, k, v = _qkv(b, s, h, kv, d, seed=s + h + d)
    got = t_ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal,
                                win, pre, backend="cuda")
    pallas = flash_attention_pallas(q, k, v, causal, win, pre, bq=32, bk=32,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **KERNEL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_ref(q, k, v, causal, win, pre)),
                               **KERNEL)


def test_flash_forward_bf16():
    q, k, v = _qkv(1, 64, 4, 2, 32, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (convert.tensor_from_numpy(np.asarray(x), "cpu")
                  for x in (jq, jk, jv))
    got = t_ops.flash_attention(tq, tk, tv, backend="pallas")
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(jq, jk, jv, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[5]])
def test_flash_gradients_match_jax_grad(case):
    b, s, h, kv, d, causal, win, pre = case
    q, k, v = _qkv(b, s, h, kv, d, seed=7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)

    def j_loss(q, k, v):
        return jnp.sum(j_ref(q, k, v, causal, win, pre) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = t_ops.flash_attention(tq, tk, tv, causal, win, pre)
    torch.sum(out * torch.from_numpy(w)).backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


def test_backend_names_and_cpu_wrapper_guard():
    assert t_ops.resolve_backend("pallas") == "cuda"
    assert t_ops.resolve_backend("pallas_interp") == "cuda"
    assert t_ops.resolve_backend("jnp") == "jnp"
    with pytest.raises(ValueError, match="unknown attention backend"):
        t_ops.resolve_backend("sdpa")
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2, 1, 4))
    # the kernel wrapper takes CUDA tensors only; the CPU route is ops'
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kern.flash_attention_fwd_cuda(q, k, v)
    torch.testing.assert_close(t_ops.flash_attention(q, k, v, backend="jnp"),
                               flash_attention_ref(q, k, v))


@pytest.mark.parametrize("window,prefix", [(0, 0), (24, 0), (16, 8)])
def test_attention_block_flash_route(monkeypatch, window, prefix):
    """The port's attention block with backend "pallas" takes the flash
    route (counted), and matches JAX's block on "pallas_interp" with
    integer window and prefix, which runs the Pallas kernel; at a length
    the block does not divide it takes the flash route all the same, and
    matches JAX's block, which falls back to full attention there."""
    b, s, d_model, h, kv, hd = 2, 64, 32, 4, 2, 8
    rng = np.random.default_rng(11)
    p = {"wq_dh": rng.standard_normal((d_model, h * hd)),
         "wk_dh": rng.standard_normal((d_model, kv * hd)),
         "wv_dh": rng.standard_normal((d_model, kv * hd)),
         "wo_hd": rng.standard_normal((h * hd, d_model)),
         "qnorm_d": rng.standard_normal((hd,)) * 0.1,
         "knorm_d": rng.standard_normal((hd,)) * 0.1}
    p = {k: (v / np.sqrt(v.shape[0]) if v.ndim == 2 else v).astype(
        np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, rope_theta=1e4,
              window=window, prefix_len=prefix, block=32)
    want = j_attn.attention_block({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), jnp.asarray(pos),
                                  backend="pallas_interp", **kw)
    calls = []
    real = t_ops.flash_attention
    monkeypatch.setattr(t_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = t_attn.attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(pos.copy()).long(), backend="pallas", **kw)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATMUL)
    want = j_attn.attention_block({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x[:, :40]),
                                  jnp.asarray(pos[:, :40]),
                                  backend="pallas_interp", **kw)
    got = t_attn.attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x[:, :40]), torch.from_numpy(pos[:, :40].copy()),
        backend="pallas", **kw)
    assert len(calls) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATMUL)


def test_lm_forward_flash_route_matches_jax(monkeypatch):
    """Reduced gemma3-1b (2 layers, d_model 64, seq 128 = 2 attention
    blocks of 64): the port's forward with attn_backend="pallas" takes the
    flash route in every layer; JAX's forward runs full_attention."""
    jcfg = j_get_config("gemma3-1b").reduced(num_layers=2, d_model=64,
                                             vocab=128)
    jcfg = dataclasses.replace(jcfg, attn_backend="pallas")
    jp = j_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    tcfg = convert.model_config_from_reference(jcfg)
    tp = convert.params_from_reference(jp, "cpu")
    tokens = np.random.default_rng(0).integers(
        0, 128, size=(2, 128)).astype(np.int32)
    want, _ = j_lm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    calls = []
    real = t_ops.flash_attention
    monkeypatch.setattr(t_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = t_lm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATMUL)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2], CASES[5]])
def test_backward_passes_plain_versions_match_autograd(case):
    """The plain versions of the CUDA backward's three kernels (dQ with
    delta, per-query-head dK/dV, the sum over each kv head's query heads),
    fed the forward's output and log-sum-exp, compose to autograd's
    gradients of the reference, within GRAD."""
    b, s, h, kv, d, causal, win, pre = case
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, s, h, kv, d, seed=9))
    dout = torch.from_numpy(np.random.default_rng(10).standard_normal(
        q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention_ref(*leaves, causal, win, pre)
    o.backward(dout)
    logits = t_ref._logits(q, k, causal, win, pre)
    lse = torch.logsumexp(logits, -1).reshape(b, h, s)
    mask = (causal, win, pre)
    dq, delta = t_ref.flash_attention_bwd_dq_ref(q, k, v, o.detach(), lse,
                                                 dout, *mask)
    torch.testing.assert_close(delta, (dout * o.detach()).sum(-1)
                               .transpose(1, 2), rtol=0, atol=0)
    dk_part, dv_part = t_ref.flash_attention_bwd_dkv_ref(q, k, v, lse, delta,
                                                         dout, *mask)
    assert dk_part.shape == dv_part.shape == (b, s, h, d)
    dk, dv = t_ref.flash_attention_bwd_sum_ref(dk_part, dv_part, kv)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, **GRAD)
