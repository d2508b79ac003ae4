"""LM-stack parity: the port's layers, attention, SSM block and LM
(forward, prefill, decode_step) against the JAX package on the same
numpy inputs and the same parameters (JAX's ``init_lm`` carried over by
``repro_torch.convert``), at reduced sizes (2 layers, d_model 64).

Tolerances, stated per test:
- elementwise layers (rms_norm, RoPE): rtol 1e-5, atol 1e-6 (the same
  float32 formula; only libm's cos/sin/rsqrt may differ by an ulp);
- matmul-bearing blocks and whole-model logits: rtol 1e-4, atol 1e-5
  (float32 sums in another order; observed gaps are below 1e-6);
- anything read back from a bf16 KV cache: rtol 1e-2, atol 1e-2 (one
  bf16 rounding of K/V, as in ``tests/test_models.py``'s f32 cache at
  1e-4 plus the bf16 step);
- masks, planned codes, planes and scales: bit for bit.

The PIM comparison (hymba under ``exact-torch`` against JAX's
``exact-jnp``) runs the JAX side under its usual ``lax.scan`` rather than
``jax.disable_jit()``: op-by-op compilation of the eager path costs about
35 s here. XLA's fused numerics could in principle move an activation
scale by an ulp and flip a 4-bit code, so that test holds the logits at
rtol 1e-3, atol 1e-3 and the greedy tokens to an agreement share of 1.0,
which it meets at this size (the observed gap is below 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.pim import PimConfig as JPimConfig
from repro.launch import serve as j_serve
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import ssm as j_ssm
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core.pim import DensePlan, PimConfig
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.models import ssm as t_ssm

ELEMENTWISE = dict(rtol=1e-5, atol=1e-6)
MATMUL = dict(rtol=1e-4, atol=1e-5)
BF16_CACHE = dict(rtol=1e-2, atol=1e-2)
ARCHS = ("qwen2.5-3b", "gemma3-1b", "mamba2-370m", "hymba-1.5b")
B, S, MAX_LEN = 2, 32, 40

_MODELS = {}


def _model(arch):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced arch,
    built once per test process."""
    if arch not in _MODELS:
        jcfg = j_get_config(arch).reduced(num_layers=2, d_model=64,
                                          vocab=128)
        jp = j_lm.init_lm(jcfg, jax.random.PRNGKey(0))
        _MODELS[arch] = (jcfg, convert.model_config_from_reference(jcfg),
                         jp, convert.params_from_reference(jp, "cpu"))
    return _MODELS[arch]


def _tokens(vocab, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return x.float().numpy() if torch.is_tensor(x) else x


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 16), _rand(rng, 16, scale=0.1)
    np.testing.assert_allclose(
        _t(t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        **ELEMENTWISE)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_halves(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 8)
    pos = (np.arange(7)[None] + np.array([[0], [33]])).astype(np.int32)
    np.testing.assert_allclose(
        _t(t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta)),
        _np(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("activation,gated", [("silu", True),
                                              ("gelu", True),
                                              ("gelu", False)])
def test_mlp(activation, gated):
    """gelu is JAX's default tanh approximation."""
    jp = j_layers.mlp_init(jax.random.PRNGKey(2), 16, 48, gated=gated)
    x = _rand(np.random.default_rng(2), 2, 3, 16)
    got = t_layers.mlp_apply(convert.params_from_reference(jp, "cpu"),
                             torch.from_numpy(x), activation)
    np.testing.assert_allclose(
        _t(got), _np(j_layers.mlp_apply(jp, jnp.asarray(x), activation)),
        **MATMUL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,causal,prefix", [
    (0, True, 0), (3, True, 0), (0, False, 0), (0, True, 2), (3, True, 2),
    (5, False, 4)])
def test_mask_bit_exact(window, causal, prefix):
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    kpos = pos[:, :6] + 1
    got = t_attn._mask(torch.from_numpy(pos.copy()),
                       torch.from_numpy(kpos.copy()), window, causal,
                       prefix)
    want = j_attn._mask(jnp.asarray(pos), jnp.asarray(kpos), window, causal,
                        prefix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(seed, b=2, s=64, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return _rand(rng, b, s, h, d), _rand(rng, b, s, kv, d), \
        _rand(rng, b, s, kv, d)


@pytest.mark.parametrize("window,causal,prefix", [
    (0, True, 0), (10, True, 0), (0, False, 0), (10, True, 6)])
def test_full_and_blockwise_attention(window, causal, prefix):
    q, k, v = _qkv(3)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    want = _np(j_attn.full_attention(*map(jnp.asarray, (q, k, v, pos)),
                                     window, causal, prefix))
    args = [torch.from_numpy(a) for a in (q, k, v, pos)]
    full = t_attn.full_attention(*args, window, causal, prefix)
    blocked = t_attn.blockwise_attention(*args, window, causal, block=16,
                                         prefix_len=prefix)
    np.testing.assert_allclose(_t(full), want, **MATMUL)
    np.testing.assert_allclose(_t(blocked), want, **MATMUL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention(per_row):
    """A block of 3 tokens into a bf16 cache at a scalar or per-row
    offset: output and updated cache against JAX."""
    jp = j_attn.attention_init(jax.random.PRNGKey(4), 32, 4, 2, 8,
                               qk_norm=True, qkv_bias=True)
    tp = convert.params_from_reference(jp, "cpu")
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 32)
    cache = {n: _rand(rng, 2, 12, 2, 8) for n in ("k", "v")}
    index = np.array([2, 7], np.int32) if per_row else 5
    jcache = {n: jnp.asarray(v, jnp.bfloat16) for n, v in cache.items()}
    tcache = {n: torch.from_numpy(v).to(torch.bfloat16)
              for n, v in cache.items()}
    jout, jnew = j_attn.decode_attention(
        jp, jnp.asarray(x), jcache, jnp.asarray(index), 4, 2, 8, 1e4,
        window=6)
    tout, tnew = t_attn.decode_attention(
        tp, torch.from_numpy(x), tcache,
        torch.from_numpy(index) if per_row else index, 4, 2, 8, 1e4,
        window=6)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_t(tnew[n]), _np(jnew[n]))
    np.testing.assert_allclose(_t(tout), _np(jout), **BF16_CACHE)


def test_attention_backend_other_than_jnp_raises():
    """A backend name the port does not know raises; the flash kernel's
    names ("cuda" and its JAX aliases) take the flash route at any length
    (here 4, which no block divides) and agree with "jnp" within MATMUL
    (float32 sums in another order)."""
    q = torch.from_numpy(_rand(np.random.default_rng(2), 1, 4, 32))
    p = convert.params_from_reference(
        j_attn.attention_init(jax.random.PRNGKey(0), 32, 4, 2, 8), "cpu")
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="unknown attention backend"):
        t_attn.attention_block(p, q, pos, 4, 2, 8, 1e4, backend="sdpa")
    want = t_attn.attention_block(p, q, pos, 4, 2, 8, 1e4, backend="jnp")
    for backend in ("cuda", "pallas", "pallas_interp"):
        torch.testing.assert_close(
            t_attn.attention_block(p, q, pos, 4, 2, 8, 1e4,
                                   backend=backend), want, **MATMUL)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["chunked", "sequential", "cuda"])
def test_ssm_apply_and_step(backend):
    jp = j_ssm.ssm_init(jax.random.PRNGKey(5), 32, 8, 2, 16)
    tp = convert.params_from_reference(jp, "cpu")
    x = _rand(np.random.default_rng(5), 2, 24, 32)
    jy, (js, jt) = j_ssm.ssm_apply(jp, jnp.asarray(x), 8, 2, 16,
                                   backend="chunked", chunk=8,
                                   return_state=True)
    ty, (ts, tt) = t_ssm.ssm_apply(tp, torch.from_numpy(x), 8, 2, 16,
                                   backend=backend, chunk=8,
                                   return_state=True)
    for got, want in ((ty, jy), (ts, js), (tt, jt)):
        np.testing.assert_allclose(_t(got), _np(want), **MATMUL)
    step_in = _rand(np.random.default_rng(6), 2, 1, 32)
    jo, jc = j_ssm.ssm_step(jp, jnp.asarray(step_in),
                            {"state": js, "conv_tail": jt}, 8, 2, 16)
    to, tc = t_ssm.ssm_step(tp, torch.from_numpy(step_in),
                            {"state": ts, "conv_tail": tt}, 8, 2, 16)
    np.testing.assert_allclose(_t(to), _np(jo), **MATMUL)
    for n in ("state", "conv_tail"):
        np.testing.assert_allclose(_t(tc[n]), _np(jc[n]), **MATMUL)


def test_softplus_is_logaddexp():
    """torch's F.softplus linearizes above 20; JAX's does not."""
    x = np.array([-50.0, -3.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(
        _t(t_ssm.softplus(torch.from_numpy(x))),
        _np(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_prefill_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg.vocab_size)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jl, _ = j_lm.forward(jp, jcfg, {"tokens": jt})
    tl, _ = t_lm.forward(tp, tcfg, {"tokens": tt})
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)

    jl, jc = j_lm.prefill(jp, jcfg, {"tokens": jt}, max_len=MAX_LEN)
    tl, tc = t_lm.prefill(tp, tcfg, {"tokens": tt}, max_len=MAX_LEN)
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)
    assert set(tc) == set(jc)
    for name in tc:
        tol = MATMUL if tc[name].dtype == torch.float32 else BF16_CACHE
        np.testing.assert_allclose(_t(tc[name]), _np(jc[name]), **tol)

    step = toks[:, :1]
    jl, _ = j_lm.decode_step(jp, jcfg, jc, jnp.asarray(step), jnp.int32(S))
    tl, _ = t_lm.decode_step(tp, tcfg, tc, torch.from_numpy(step).long(), S)
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)


def test_prefill_logits_index():
    jcfg, tcfg, jp, tp = _model("hymba-1.5b")
    toks = _tokens(jcfg.vocab_size)
    jl, _ = j_lm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                         max_len=MAX_LEN, logits_index=jnp.int32(9))
    tl, _ = t_lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                         max_len=MAX_LEN, logits_index=9)
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_prefill_then_decode_equals_forward(arch, cache_dtype):
    """Teacher forcing in the port alone: prefill of the first half, then
    decode of each next token, equals the forward logits at rtol 1e-4,
    atol 1e-4 with an f32 cache (``tests/test_models.py``'s bound) and
    within the bf16-cache tolerance with a bf16 one."""
    _, cfg, _, params = _model(arch)
    cfg = dataclasses.replace(cfg, ssd_backend="cuda")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=12, seed=1)).long()
    logits, _ = t_lm.forward(params, cfg, {"tokens": toks})
    tol = dict(rtol=1e-4, atol=1e-4) if cache_dtype == torch.float32 \
        else BF16_CACHE
    lg, cache = t_lm.prefill(params, cfg, {"tokens": toks[:, :6]},
                             max_len=12, cache_dtype=cache_dtype)
    np.testing.assert_allclose(_t(lg), _t(logits[:, 5]), **tol)
    for t in range(6, 11):
        lg, cache = t_lm.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_t(lg), _t(logits[:, t]), **tol)


def test_decode_per_row_index_matches_scalar():
    _, cfg, _, params = _model("qwen2.5-3b")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=8, seed=2)).long()
    _, c1 = t_lm.prefill(params, cfg, {"tokens": toks}, max_len=10)
    _, c2 = t_lm.prefill(params, cfg, {"tokens": toks}, max_len=10)
    l1, _ = t_lm.decode_step(params, cfg, c1, toks[:, :1], 8)
    l2, _ = t_lm.decode_step(params, cfg, c2, toks[:, :1],
                             torch.tensor([8, 8]))
    assert torch.equal(l1, l2)


def test_token_stop_mask():
    toks = torch.tensor([[1, 5], [7, 2]])
    got = t_lm.token_stop_mask(toks, [5, 7])
    want = j_lm.token_stop_mask(jnp.asarray(toks.numpy()), jnp.asarray([5, 7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(t_lm.token_stop_mask(toks, []).any())


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced(num_layers=2, d_model=64, vocab=128)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_lm.init_lm(cfg, 0, device="cpu")


def test_forward_rejects_unported_attention_backend():
    """The port's forward passes ``cfg.attn_backend`` on: an unknown name
    raises, the kernel backend runs (its flash route, here at a length its
    block does not divide) and agrees with "jnp" within MATMUL; ``prefill``
    never passes it (as in JAX), so it runs whatever the config says."""
    _, cfg, _, params = _model("qwen2.5-3b")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=8)).long()
    with pytest.raises(ValueError, match="unknown attention backend"):
        t_lm.forward(params, dataclasses.replace(cfg, attn_backend="sdpa"),
                     {"tokens": toks})
    want, _ = t_lm.forward(params, cfg, {"tokens": toks})
    kernel_cfg = dataclasses.replace(cfg, attn_backend="pallas")
    got, _ = t_lm.forward(params, kernel_cfg, {"tokens": toks})
    torch.testing.assert_close(got, want, **MATMUL)
    logits, _ = t_lm.prefill(params, dataclasses.replace(
        cfg, attn_backend="sdpa"), {"tokens": toks}, max_len=8)
    assert logits.shape == (B, cfg.padded_vocab)


# ---------------------------------------------------------------------------
# PIM programming and the planned path
# ---------------------------------------------------------------------------
def _pim_pair():
    jcfg, tcfg, jp, tp = _model("hymba-1.5b")
    jplanned = j_serve.plan_params_for_pim(
        jp, JPimConfig(weight_bits=4, act_bits=4, substrate="exact-jnp"))
    tplanned = t_serve.plan_params_for_pim(
        tp, PimConfig(weight_bits=4, act_bits=4, substrate="exact-torch"))
    return jcfg, tcfg, jplanned, tplanned


def test_plan_params_for_pim_bit_exact_per_layer():
    """Planned attention/MLP projections: codes, scales, planes and padded
    scales equal JAX's converted plans, layer by layer; fake-quantized
    leaves (SSM projections, embedding) equal JAX's bit for bit."""
    _, _, jplanned, tplanned = _pim_pair()
    converted = convert.planned_params_from_reference(jplanned, "cpu")
    layers_t, layers_c = tplanned["layers"], converted["layers"]
    planned = 0
    for blk in ("attn", "mlp"):
        for name, plans in layers_t[blk].items():
            if not isinstance(plans, list):
                continue
            assert len(plans) == 2 and len(layers_c[blk][name]) == 2
            for mine, theirs in zip(plans, layers_c[blk][name]):
                assert isinstance(mine, DensePlan)
                for f in ("values", "scale", "planes", "padded_scale"):
                    assert torch.equal(getattr(mine, f),
                                       getattr(theirs, f)), (blk, name, f)
                assert (mine.bits, mine.k, mine.n) == \
                    (theirs.bits, theirs.k, theirs.n)
                assert mine.substrate == theirs.substrate == "exact-torch"
            planned += 1
    assert planned == 7          # q, k, v, o, wi, wg, wo
    for name, leaf in layers_t["ssm"].items():
        assert torch.equal(leaf, layers_c["ssm"][name]), name
    assert torch.equal(tplanned["embed_vd"], converted["embed_vd"])


def test_hymba_exact_torch_matches_jax_exact_jnp():
    jcfg, tcfg, jplanned, _ = _pim_pair()
    tplanned = convert.planned_params_from_reference(jplanned, "cpu")
    toks = _tokens(jcfg.vocab_size)
    jl, jc = j_lm.prefill(jplanned, jcfg, {"tokens": jnp.asarray(toks)},
                          max_len=MAX_LEN)
    tl, tc = t_lm.prefill(tplanned, tcfg, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN)
    tol = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_t(tl), _np(jl), **tol)
    jtok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    ttok = tl.argmax(-1)[:, None]
    assert (ttok.numpy() == jtok).mean() == 1.0
    jl, _ = j_lm.decode_step(jplanned, jcfg, jc, jnp.asarray(jtok),
                             jnp.int32(S))
    tl, _ = t_lm.decode_step(tplanned, tcfg, tc, ttok, S)
    np.testing.assert_allclose(_t(tl), _np(jl), **tol)
    assert (tl.argmax(-1).numpy() == np.asarray(jnp.argmax(jl, -1))).mean() \
        == 1.0
