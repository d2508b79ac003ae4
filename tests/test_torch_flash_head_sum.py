"""The flash backward's head sum (the third backward kernel, GQA): its
plain version written as the kernel's own arithmetic, float32 adds in
head order from 0 (``flash_attention_bwd_sum_ordered``, which the card's
kernel equals bit for bit), against ``flash_attention_bwd_sum_ref``
(``torch.sum``) within FLASH_SUM_REL = 1e-6 of the largest magnitude
(float32 sums of up to 8 terms in another order), and equal to it where
two heads or fewer leave no order to choose; and the whole backward, the
plain dQ and dK/dV passes joined by the ordered sum, against ``jax.grad``
of the JAX package's reference at reduced gemma3-1b shapes (4 query heads
on 1 kv head, a window and a global layer) within rtol 1e-4, atol 1e-5
(float32 autograd through the same formula, as tests/test_torch_flash.py
states)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import ref as t_ref

FLASH_SUM_REL = 1e-6
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,d", ((2, 64, 4, 1, 256), (1, 37, 6, 2, 30),
                                        (2, 16, 8, 1, 64), (1, 8, 2, 1, 16),
                                        (1, 8, 4, 4, 8)))
def test_ordered_head_sum_matches_torch_sum(b, s, h, kv, d):
    rng = np.random.default_rng(b * s + h * d)
    parts = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)) for _ in range(2)]
    got = t_ref.flash_attention_bwd_sum_ordered(*parts, kv)
    want = t_ref.flash_attention_bwd_sum_ref(*parts, kv)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, s, kv, d)
        gap = (g - w).abs().max().item() / w.abs().max().item()
        assert gap <= FLASH_SUM_REL
        if h // kv <= 2:
            assert torch.equal(g, w)


def test_ordered_head_sum_adds_in_head_order():
    """Three heads whose sum depends on the order: ((0 + a) + b) + c."""
    a, b, c = 1.0, 2.0 ** -24, 2.0 ** -24
    part = torch.tensor([a, b, c], dtype=torch.float32).reshape(1, 1, 3, 1)
    got = t_ref.flash_attention_bwd_sum_ordered(part, part, 1)[0].item()
    assert got == np.float32(np.float32(a + np.float32(b)) + np.float32(c))
    assert got == 1.0   # 1 + 2^-24 rounds to 1 twice; (b + c) + a would not


@pytest.mark.parametrize("window", (32, 0))
def test_backward_with_ordered_sum_matches_jax_grad(window):
    b, s, h, kv, d = 1, 128, 4, 1, 64
    rng = np.random.default_rng(window + 11)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def j_loss(q, k, v):
        return jnp.sum(j_ref(q, k, v, True, window, 0) * dout)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    mask = (True, window, 0)
    o = t_ref.flash_attention_ref(tq, tk, tv, *mask)
    lse = torch.logsumexp(t_ref._logits(tq, tk, *mask), -1).reshape(b, h, s)
    dq, delta = t_ref.flash_attention_bwd_dq_ref(tq, tk, tv, o, lse, tdo,
                                                 *mask)
    dk_part, dv_part = t_ref.flash_attention_bwd_dkv_ref(tq, tk, tv, lse,
                                                         delta, tdo, *mask)
    dk, dv = t_ref.flash_attention_bwd_sum_ordered(dk_part, dv_part, kv)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)
