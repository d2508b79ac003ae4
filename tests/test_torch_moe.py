"""MoE parity: the port's router, expert FFN routes, expert-stacked plans
and expert dispatch, MoE LM and serving set-up against the JAX package
on the same numpy inputs and the same parameters (JAX's ``init_lm`` and
``plan_params_for_pim`` carried over by ``repro_torch.convert``), at
reduced sizes of ``moonshot-v1-16b-a3b`` (shared experts) and
``qwen3-moe-30b-a3b`` (2 layers, d_model 64, 8 experts, top-2).

Tolerances, stated per test:
- router probabilities and losses: rtol 1e-6, atol 1e-6 (the same
  float32 formula; the router logits' sums may run in another order);
  the chosen experts equal (seeded random floats give no ties);
- the float MoE FFN and its dense oracle: rtol 1e-5, atol 1e-6 (float32
  sums in another order);
- programming (codes, scales, planes, padded scales) and the exact and
  analog (``rng=None``) expert matmuls: bit for bit; ``emulate``: rtol
  1e-6, atol 1e-6 (a float matmul);
- the PIM MoE FFN on converted plans: rtol 1e-5, atol 1e-6 (bit-equal
  products, combined over the experts in another order);
- whole-model logits: as ``tests/test_torch_lm.py`` (float rtol 1e-4,
  atol 1e-5; bf16 cache reads 1e-2; the PIM route 1e-3 with greedy
  agreement 1.0, JAX under its usual ``lax.scan``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as j_engine
from repro.configs.base import get_config as j_get_config
from repro.core import pim as j_pim
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch import convert, engine
from repro_torch.core import pim
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe

ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b")
ROUTER = dict(rtol=1e-6, atol=1e-6)
FFN = dict(rtol=1e-5, atol=1e-6)
MATMUL = dict(rtol=1e-4, atol=1e-5)
BF16_CACHE = dict(rtol=1e-2, atol=1e-2)
PIM_LOGITS = dict(rtol=1e-3, atol=1e-3)
B, S, MAX_LEN = 2, 16, 24

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


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, dtype=np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(vocab, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


def _moe_params(arch, layer=0):
    """The reduced arch's layer-``layer`` MoE block, JAX's and the port's."""
    jcfg, tcfg, jp, tp = _model(arch)
    jblk = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"]["moe"])
    return jcfg, jblk, convert.params_from_reference(jblk, "cpu")


# ---------------------------------------------------------------------------
# router and the float route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    jcfg, jblk, tblk = _moe_params(arch)
    x = _rand((24, jcfg.d_model), 1)
    jout = j_moe._route(jblk["router_de"], jnp.asarray(x),
                        jcfg.experts_per_token)
    tout = t_moe._route(tblk["router_de"], torch.from_numpy(x),
                        jcfg.experts_per_token)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    for got, want in zip(tout[:1] + tout[2:], jout[:1] + jout[2:]):
        np.testing.assert_allclose(_np(got), _np(want), **ROUTER)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_float_matches_jax_and_oracle(arch):
    """The local grouped route against JAX's ``moe_apply`` and both
    packages' dense oracle, with the router losses it adds to aux."""
    jcfg, jblk, tblk = _moe_params(arch, layer=1)
    x = _rand((2, 12, jcfg.d_model), 2)
    k = jcfg.experts_per_token
    jaux, taux = {}, {}
    want = j_moe.moe_apply(jblk, jnp.asarray(x), k, jaux)
    got = t_moe.moe_apply(tblk, torch.from_numpy(x), k, taux)
    np.testing.assert_allclose(_np(got), _np(want), **FFN)
    np.testing.assert_allclose(
        _np(got), _np(j_moe.moe_reference(jblk, jnp.asarray(x), k)), **FFN)
    np.testing.assert_allclose(
        _np(t_moe.moe_reference(tblk, torch.from_numpy(x), k)), _np(want),
        **FFN)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(taux[name]), _np(jaux[name]),
                                   **ROUTER)
    assert ("shared" in tblk) == (arch == "moonshot-v1-16b-a3b")


def test_moe_init_names_shapes_and_scales():
    gen = torch.Generator().manual_seed(3)
    p = t_moe.moe_init(gen, 64, 8, 48, shared_experts=2, shared_d_ff=48)
    jp = j_moe.moe_init(jax.random.PRNGKey(3), 64, 8, 48, shared_experts=2,
                        shared_d_ff=48)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == shapes
    # standard deviations: 1/sqrt(d_model) in, 1/sqrt(d_ff) out
    assert abs(float(p["wi_edf"].std()) * 8 - 1) < 0.02
    assert abs(float(p["wo_efd"].std()) * 48 ** 0.5 - 1) < 0.02


# ---------------------------------------------------------------------------
# expert-stacked plans and the engine's expert dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("e,k,n", [(3, 44, 20), (2, 600, 136)])
def test_prepare_expert_weights_bit_exact(e, k, n, bits):
    """K = 44 pads to a WDM chunk, K = 600 to the kernel's 512-row tiles."""
    w = _rand((e, k, n), 4)
    jplan = j_pim.prepare_expert_weights(
        jnp.asarray(w), j_pim.PimConfig(weight_bits=bits, act_bits=bits))
    cfg = pim.PimConfig(weight_bits=bits, act_bits=bits,
                        substrate="exact-torch")
    plan = pim.prepare_expert_weights(torch.from_numpy(w), cfg)
    programmed = engine.program(torch.from_numpy(w), cfg, kind="experts")
    assert isinstance(programmed, pim.ExpertStackedPlan)
    assert plan.num_experts == jplan.num_experts == e
    assert plan.shape == (e, k, n) and plan.bits == bits
    for f in ("values", "scale", "planes", "padded_scale"):
        np.testing.assert_array_equal(getattr(plan.dense, f).numpy(),
                                      np.asarray(getattr(jplan.dense, f)))
        assert torch.equal(getattr(programmed.dense, f),
                           getattr(plan.dense, f))
    one = plan.expert(e - 1)
    assert one.planes.is_contiguous() and \
        one.planes.data_ptr() == plan.dense.planes[e - 1].data_ptr()
    converted = convert.plan_from_reference(jplan, "cpu")
    assert isinstance(converted, pim.ExpertStackedPlan)
    assert torch.equal(converted.dense.planes, plan.dense.planes)


# port substrate -> the JAX substrate it is held to
EXPERT_PAIRS = (("exact-torch", "exact-jnp"), ("exact-cuda", "exact-pallas"),
                ("analog", "analog"), ("emulate", "emulate"))


@pytest.mark.filterwarnings("ignore:analog readout without an rng")
@pytest.mark.parametrize("paired", (False, True))
@pytest.mark.parametrize("substrate,jax_substrate", EXPERT_PAIRS)
def test_expert_matmul_matches_jax(substrate, jax_substrate, paired):
    """Broadcast x (2, 5, K) -> (E, 2, 5, N), and paired x (E, 7, K) ->
    (E, 7, N); ``exact-cuda`` runs its plain version here and is held to
    JAX's Pallas kernel in interpret mode, ``analog`` at ``rng=None``."""
    e, k, n = 3, 44, 20
    w = _rand((e, k, n), 5)
    x = _rand((e, 7, k) if paired else (2, 5, k), 6)
    jplan = j_engine.program(jnp.asarray(w), j_pim.PimConfig(
        substrate=jax_substrate), kind="experts")
    plan = engine.program(torch.from_numpy(w),
                          pim.PimConfig(substrate=substrate), kind="experts")
    want = j_engine.matmul(jnp.asarray(x), jplan, paired=paired)
    got = engine.matmul(torch.from_numpy(x), plan, paired=paired)
    assert tuple(got.shape) == tuple(want.shape) == \
        ((e,) + x.shape[int(paired):-1] + (n,))
    if substrate == "emulate":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.filterwarnings("ignore:analog readout without an rng")
def test_expert_matmul_shares_codes_and_equals_per_expert():
    """Broadcast rows quantized once equal each expert's own dense call,
    and the paired route equals expert e's call on x[e], on every exact
    substrate and the deterministic analog one."""
    e, k, n = 4, 40, 24
    w, x = _rand((e, k, n), 7), _rand((9, k), 8)
    xe = _rand((e, 9, k), 9)
    for substrate in ("exact-cuda", "exact-torch", "analog-cuda"):
        cfg = pim.PimConfig(substrate=substrate)
        plan = engine.program(torch.from_numpy(w), cfg, kind="experts")
        out = engine.matmul(torch.from_numpy(x), plan)
        paired = engine.matmul(torch.from_numpy(xe), plan, paired=True)
        for i in range(e):
            dense = engine.program(torch.from_numpy(w[i]), cfg)
            assert torch.equal(out[i], engine.matmul(torch.from_numpy(x),
                                                     dense))
            assert torch.equal(paired[i], engine.matmul(
                torch.from_numpy(xe[i]), dense))


def test_expert_matmul_guards_and_rng():
    w = torch.from_numpy(_rand((3, 16, 8), 10))
    plan = engine.program(w, pim.PimConfig(substrate="exact-torch"),
                          kind="experts")
    dense = engine.program(w[0], pim.PimConfig(substrate="exact-torch"))
    x = torch.from_numpy(_rand((5, 16), 11))
    with pytest.raises(ValueError, match="only meaningful"):
        engine.matmul(x, dense, paired=True)
    with pytest.raises(ValueError, match="leading \\(3, ...\\) axis"):
        engine.matmul(torch.zeros(2, 5, 16), plan, paired=True)
    with pytest.raises(ValueError, match="contraction mismatch"):
        engine.matmul(torch.zeros(5, 12), plan)
    # noise: one generator per expert, drawn from the caller's in order,
    # so a generator of the same state repeats the output bit for bit
    aplan = engine.program(w, pim.PimConfig(substrate="analog",
                                            read_noise_sigma=0.05),
                           kind="experts")
    a = engine.matmul(x, aplan, rng=torch.Generator().manual_seed(1))
    b = engine.matmul(x, aplan, rng=torch.Generator().manual_seed(1))
    c = engine.matmul(x, aplan, rng=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="requires an rng"):
        engine.matmul(x, aplan)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_pim_matches_jax_on_converted_plans(arch):
    """``_moe_pim`` on JAX's programmed expert stacks, converted, against
    JAX's ``_moe_pim`` on the same router output (``exact-jnp`` and
    ``exact-torch``), in one chunk of experts and in chunks of one."""
    jcfg, jblk, _ = _moe_params(arch)
    cfg = j_pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-jnp")
    jplans = {n: j_engine.program(jblk[n], cfg, kind="experts")
              for n in ("wi_edf", "wg_edf", "wo_efd")}
    tplans = {n: convert.plan_from_reference(p, "cpu")
              for n, p in jplans.items()}
    x = _rand((20, jcfg.d_model), 12)
    probs, ids, _, _ = j_moe._route(jblk["router_de"], jnp.asarray(x),
                                    jcfg.experts_per_token)
    want = j_moe._moe_pim(jnp.asarray(x), probs, ids, jplans["wi_edf"],
                          jplans["wg_edf"], jplans["wo_efd"])
    args = (torch.from_numpy(x), torch.from_numpy(np.asarray(probs)),
            torch.from_numpy(np.asarray(ids)).long(), tplans["wi_edf"],
            tplans["wg_edf"], tplans["wo_efd"])
    got = t_moe._moe_pim(*args)
    np.testing.assert_allclose(_np(got), _np(want), **FFN)
    limit = t_moe.PIM_CHUNK_ELEMENTS
    try:
        t_moe.PIM_CHUNK_ELEMENTS = 1
        np.testing.assert_allclose(_np(t_moe._moe_pim(*args)), _np(got),
                                   **FFN)
    finally:
        t_moe.PIM_CHUNK_ELEMENTS = limit


# ---------------------------------------------------------------------------
# the MoE LM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_prefill_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg.vocab_size)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jl, jaux = j_lm.forward(jp, jcfg, {"tokens": jt})
    tl, taux = t_lm.forward(tp, tcfg, {"tokens": tt})
    np.testing.assert_allclose(_np(tl), _np(jl), **MATMUL)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(taux[name]), _np(jaux[name]),
                                   **ROUTER)

    jl, jc = j_lm.prefill(jp, jcfg, {"tokens": jt}, max_len=MAX_LEN)
    tl, tc = t_lm.prefill(tp, tcfg, {"tokens": tt}, max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), **MATMUL)
    for name in tc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   **BF16_CACHE)
    step = toks[:, :1]
    jl, _ = j_lm.decode_step(jp, jcfg, jc, jnp.asarray(step), jnp.int32(S))
    tl, _ = t_lm.decode_step(tp, tcfg, tc, torch.from_numpy(step).long(), S)
    np.testing.assert_allclose(_np(tl), _np(jl), **MATMUL)


_PLANNED = {}


def _planned(arch):
    """(JAX cfg, port cfg, JAX planned tree, port planned tree) at w4a4 on
    ``exact-jnp`` / ``exact-torch``, built once per test process."""
    if arch not in _PLANNED:
        jcfg, tcfg, jp, tp = _model(arch)
        _PLANNED[arch] = (jcfg, tcfg, j_serve.plan_params_for_pim(
            jp, j_pim.PimConfig(weight_bits=4, act_bits=4,
                                substrate="exact-jnp")),
            t_serve.plan_params_for_pim(tp, pim.PimConfig(
                weight_bits=4, act_bits=4, substrate="exact-torch")))
    return _PLANNED[arch]


def _assert_trees_equal(mine, theirs, path=()):
    """Every plan field and every tensor leaf equal, bit for bit."""
    if isinstance(mine, dict):
        assert set(mine) == set(theirs), path
        for k in mine:
            _assert_trees_equal(mine[k], theirs[k], path + (k,))
    elif isinstance(mine, list):
        assert len(mine) == len(theirs), path
        for a, b in zip(mine, theirs):
            assert type(a) is type(b), path
            if isinstance(a, pim.ExpertStackedPlan):
                assert a.num_experts == b.num_experts, path
                a, b = a.dense, b.dense
            for f in ("values", "scale", "planes", "padded_scale"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (path, f)
            assert (a.bits, a.k, a.n, a.substrate) == \
                (b.bits, b.k, b.n, b.substrate), path
    else:
        assert torch.equal(mine, theirs), path


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_trees_match_jax(arch):
    """Expert stacks as lists of ExpertStackedPlan, the shared expert and
    attention as lists of DensePlan, the router float: the port's
    planning equals JAX's carried over by ``planned_params_from_reference``."""
    _, tcfg, jplanned, tplanned = _planned(arch)
    converted = convert.planned_params_from_reference(jplanned, "cpu")
    _assert_trees_equal(tplanned, converted)
    moe = tplanned["layers"]["moe"]
    assert all(isinstance(p, pim.ExpertStackedPlan) and
               p.num_experts == tcfg.num_experts for p in moe["wi_edf"])
    assert torch.is_tensor(moe["router_de"])
    assert ("shared" in moe) == (arch == "moonshot-v1-16b-a3b")
    if "shared" in moe:
        assert all(isinstance(p, pim.DensePlan)
                   for p in moe["shared"]["wo_hd"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_pim_prefill_decode_match_jax(arch):
    """The planned model on ``exact-torch`` (converted JAX plans) against
    JAX's ``exact-jnp`` route: the prefill under JAX's ``lax.scan``, then
    (qwen3-moe, whose eager step costs a quarter of moonshot's op-by-op
    compilation) the decode step eagerly. JAX's scanned decode step on
    expert plans differs from its own eager one by up to 0.08 in these
    logits (XLA's fused arithmetic flips 4-bit codes of two-row
    activations), so the step is held to JAX eager, the reference
    semantics, as the CNN's parity tests are."""
    jcfg, tcfg, jplanned, _ = _planned(arch)
    tplanned = convert.planned_params_from_reference(jplanned, "cpu")
    toks = _tokens(jcfg.vocab_size)
    jl, jc = j_lm.prefill(jplanned, jcfg, {"tokens": jnp.asarray(toks)},
                          max_len=MAX_LEN)
    tl, tc = t_lm.prefill(tplanned, tcfg, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), **PIM_LOGITS)
    jtok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    ttok = tl.argmax(-1)[:, None]
    assert (ttok.numpy() == jtok).mean() == 1.0
    if arch != "qwen3-moe-30b-a3b":
        return
    with jax.disable_jit():
        jl, _ = j_lm.decode_step(jplanned, jcfg, jc, jnp.asarray(jtok),
                                 jnp.int32(S))
    tl, _ = t_lm.decode_step(tplanned, tcfg, tc, ttok, S)
    np.testing.assert_allclose(_np(tl), _np(jl), **PIM_LOGITS)
    assert (tl.argmax(-1).numpy() == np.asarray(jnp.argmax(jl, -1))).mean() \
        == 1.0


def test_lm_loss_moe_objective_matches_jax():
    jcfg, tcfg, jp, tp = _model("moonshot-v1-16b-a3b")
    toks = _tokens(jcfg.vocab_size, s=S + 1, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jm = j_train.lm_loss(jp, jcfg, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tloss, tm = t_train.lm_loss(tp, tcfg, {k: torch.from_numpy(v).long()
                                           for k, v in batch.items()})
    np.testing.assert_allclose(_np(tloss), _np(jloss), rtol=1e-6, atol=1e-6)
    assert set(tm) == set(jm) == {"loss", "moe_lb"}
    for name in tm:
        np.testing.assert_allclose(_np(tm[name]), _np(jm[name]), rtol=1e-6,
                                   atol=1e-6)
    assert float(tloss) > float(tm["loss"])      # the router terms count


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_streamed_setup_equals_init_then_plan():
    """Serving's set-up programs each layer as it is drawn; the result
    equals ``init_lm`` followed by ``plan_params_for_pim``, bit for bit."""
    cfg, params, substrate, pim_cfg, _ = t_serve._setup(
        "moonshot-v1-16b-a3b", 2, 32, True, 4, False, "exact-torch", None,
        device="cpu")
    want = t_serve.plan_params_for_pim(t_lm.init_lm(cfg, 0, device="cpu"),
                                       pim_cfg)
    assert substrate == "exact-torch" and cfg.is_moe
    _assert_trees_equal(params, want)
    assert list(params) == list(want)


def test_serve_moonshot_pim_cpu():
    res = t_serve.serve("moonshot-v1-16b-a3b", batch=2, prompt_len=6, gen=3,
                        layers=1, d_model=32, pim=True, device="cpu")
    assert res["generated"].shape == (2, 3)
    assert res["pim_substrate"] == "exact-cuda"
    assert np.isfinite(res["tokens_per_s"]) and res["tokens_per_s"] > 0
    assert res["opima_latency_ms_per_token_batch"] > 0


def test_moe_float_params_serve_and_decode_like_forward():
    """Teacher forcing through the float MoE route: prefill, then each
    next token decoded, equals the forward logits (f32 cache, rtol 1e-4,
    atol 1e-4)."""
    _, cfg, _, params = _model("qwen3-moe-30b-a3b")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=10, seed=4)).long()
    logits, _ = t_lm.forward(params, cfg, {"tokens": toks})
    lg, cache = t_lm.prefill(params, cfg, {"tokens": toks[:, :5]},
                             max_len=10, cache_dtype=torch.float32)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(lg), _np(logits[:, 4]), **tol)
    for t in range(5, 9):
        lg, cache = t_lm.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(logits[:, t]), **tol)


def test_remat_forward_keeps_router_losses():
    _, cfg, _, params = _model("moonshot-v1-16b-a3b")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=8)).long()
    want, waux = t_lm.forward(params, cfg, {"tokens": toks})
    got, gaux = t_lm.forward(params, dataclasses.replace(cfg, remat=True),
                             {"tokens": toks})
    assert torch.equal(got, want)
    assert torch.equal(gaux["moe_lb_loss"], waux["moe_lb_loss"])
    assert torch.equal(gaux["moe_z_loss"], waux["moe_z_loss"])
