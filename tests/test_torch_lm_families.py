"""The encoder-decoder (whisper) and the VLM prefix (paligemma) in the
port against the JAX package, at reduced sizes (``reduced(num_layers=2,
d_model=64, vocab=128)``: 2 encoder layers for whisper, 16 stub patches
of dim 32 for paligemma), on the same numpy inputs and the same
parameters (JAX's ``init_lm`` carried over by ``repro_torch.convert``).
The JAX side runs eagerly (its layer scans compile as in its own tests;
nothing is wrapped in ``jax.jit``).

Tolerances, stated per test:
- logits (forward, prefill, every decode step) and float32 caches: rtol
  1e-4, atol 1e-5 (float32 sums in another order; observed gaps are
  below 1e-6);
- anything read back from a bf16 cache (the self-attention's K/V and,
  for whisper, the cross-attention's ``xk``/``xv``): rtol 1e-2, atol
  1e-2 (one bf16 rounding, which a 1e-6 gap upstream can move by one
  bf16 ulp);
- the loss and gradient norm of a train step: rtol 1e-5; the parameters
  after it as ``tests/test_torch_train.py`` holds them (every element
  within 1e-4, at most 1e-4 of the elements beyond 1e-6);
- planned codes, scales, planes, ABFT records and tags, the request's
  drawn inputs and greedy tokens: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.pim import PimConfig as JPimConfig
from repro.data import pipeline as j_data
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import lm as j_lm
from repro.optim import adamw as j_adamw
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core.pim import DensePlan, PimConfig
from repro_torch.engine import mesh as t_engine_mesh
from repro_torch.launch import mesh as t_launch_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw as t_adamw
from repro_torch.serving import slots as t_slots
from repro_torch.tree import flatten_with_path, leaves

MATMUL = dict(rtol=1e-4, atol=1e-5)
BF16_CACHE = dict(rtol=1e-2, atol=1e-2)
SCALAR = dict(rtol=1e-5)
PARAM_ATOL, PARAM_FINE, PARAM_SHARE = 1e-4, 1e-6, 1e-4
FAMILIES = ("whisper-medium", "paligemma-3b")
B, S, GEN = 2, 12, 2
OPT = dict(lr=3e-4, total_steps=10, warmup_steps=2)

_MODELS = {}


def _model(arch):
    """(JAX cfg, port cfg, JAX params, port params), built once per test
    process."""
    if arch not in _MODELS:
        jcfg = j_get_config(arch).reduced(num_layers=2, d_model=64,
                                          vocab=128)
        jp = j_lm.init_lm(jcfg, jax.random.PRNGKey(0))
        _MODELS[arch] = (jcfg, convert.model_config_from_reference(jcfg),
                         jp, convert.params_from_reference(jp, "cpu"))
    return _MODELS[arch]


def _batch(cfg, seed=0, b=B, s=S):
    """tokens, then the family's stub input, as numpy arrays (frames as
    long as the prompt, as the JAX package's serve and data pipeline make
    them)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(b, s)).astype(np.int32)}
    if cfg.vision_tokens:
        out["patches"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return x.float().numpy()


def _prefix(cfg):
    return cfg.vision_tokens


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_lm_tree_matches_jax(arch):
    """The port draws the tree JAX draws: the same leaves and shapes,
    including ``enc_layers`` / ``enc_norm_d``, the decoder's ``lnx_d`` /
    ``xattn`` and ``vproj_dh``."""
    jcfg, tcfg, _, tp = _model(arch)
    shapes = lambda tree: {"/".join(p): tuple(t.shape)
                           for p, t in flatten_with_path(tree)}
    mine = t_lm.init_lm(tcfg, 0, device="cpu")
    assert shapes(mine) == shapes(tp)
    if jcfg.encoder_layers:
        assert mine["enc_layers"]["attn"]["wq_dh"].shape[0] == 2
        assert "xattn" in mine["layers"] and "lnx_d" in mine["layers"]
        assert "xattn" not in mine["enc_layers"]
    else:
        assert mine["vproj_dh"].shape == (jcfg.vision_dim, jcfg.d_model)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, backend):
    """Logits over every position (the VLM's prefix too). With
    ``"pallas"`` the port takes the flash route's plain version: causal
    False in whisper's encoder, prefix_len 16 in paligemma's decoder;
    JAX's ``lax.scan`` over traced windows never reaches its kernel, so
    its forward is the "jnp" one either way."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg)
    if ("forward", arch) not in _MODELS:
        _MODELS["forward", arch] = j_lm.forward(jp, jcfg, _jax(batch))[0]
    jl = _MODELS["forward", arch]
    tl, aux = t_lm.forward(tp, dataclasses.replace(tcfg, attn_backend=backend),
                           _torch(batch))
    assert tl.shape == (B, S + _prefix(jcfg), jcfg.padded_vocab)
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)
    assert aux["moe_lb_loss"] == 0.0


def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = _model("whisper-medium")
    frames = _batch(jcfg)["frames"]
    np.testing.assert_allclose(
        _t(t_lm.encode(tp, tcfg, torch.from_numpy(frames))),
        _np(j_lm.encode(jp, jcfg, jnp.asarray(frames))), **MATMUL)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_every_decode_step_match_jax(arch, cache_dtype):
    """The prefill's logits and cache (K/V, and whisper's cross-attention
    ``xk``/``xv`` of the encoder's length), then GEN decode steps at the
    positions after the prefix, each step's logits; both packages decode
    JAX's greedy tokens."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg, seed=1)
    start = S + _prefix(jcfg)
    max_len = start + GEN
    jl, jc = j_lm.prefill(jp, jcfg, _jax(batch), max_len=max_len,
                          cache_dtype=getattr(jnp, cache_dtype))
    tl, tc = t_lm.prefill(tp, tcfg, _torch(batch), max_len=max_len,
                          cache_dtype=getattr(torch, cache_dtype))
    np.testing.assert_allclose(_t(tl), _np(jl), **MATMUL)
    assert set(tc) == set(jc)
    assert set(tc) == ({"k", "v", "xk", "xv"} if jcfg.encoder_layers
                       else {"k", "v"})
    tol = MATMUL if cache_dtype == "float32" else BF16_CACHE
    for name in tc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        assert tc[name].dtype == getattr(torch, cache_dtype)
        np.testing.assert_allclose(_t(tc[name]), _np(jc[name]), **tol)
    for g in range(GEN):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = j_lm.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                  jnp.int32(start + g))
        tl, tc = t_lm.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                                  start + g)
        np.testing.assert_allclose(_t(tl), _np(jl), **tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_equals_forward(arch):
    """Teacher forcing in the port alone, float32 cache: prefill of the
    first half and decode of each next token equal the forward's logits at
    the same positions (rtol 1e-4, atol 1e-4, as
    ``tests/test_torch_lm.py`` holds the other families)."""
    _, cfg, _, params = _model(arch)
    batch = _torch(_batch(cfg, seed=2))
    logits, _ = t_lm.forward(params, cfg, batch)
    half = dict(batch, tokens=batch["tokens"][:, :6])
    p = _prefix(cfg)
    lg, cache = t_lm.prefill(params, cfg, half, max_len=p + S,
                             cache_dtype=torch.float32)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(lg), _t(logits[:, p + 5]), **tol)
    for t in range(6, S - 1):
        lg, cache = t_lm.decode_step(params, cfg, cache,
                                     batch["tokens"][:, t:t + 1], p + t)
        np.testing.assert_allclose(_t(lg), _t(logits[:, p + t]), **tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_chunked_prefill_and_slots_refuse(arch):
    """As in the JAX package: chunked prefill and the continuous-batching
    slots carry no encoder or prefix inputs."""
    _, cfg, _, params = _model(arch)
    cache = t_lm.init_cache(cfg, 1, 8, enc_len=4, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        t_lm.prefill_chunk(params, cfg, cache, torch.zeros((1, 4),
                                                           dtype=torch.long),
                           0)
    with pytest.raises(NotImplementedError, match="encoder/vision"):
        t_slots.check_slot_compatible(cfg)


# ---------------------------------------------------------------------------
# serving: plans, the set-up and the static loop
# ---------------------------------------------------------------------------
def _plans(tree, path=()):
    """(path, plan) of every plan list of a planned tree, flattened."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _plans(v, path + (k,))
        elif isinstance(v, list):
            yield path + (k,), v


def _same_plan(a, b, float_sums_exact=True):
    """Two plans equal: codes, scales, planes, tag and the ABFT record bit
    for bit; with ``float_sums_exact`` False (a plan of JAX's) the record's
    float32 sums ``col_f32`` and ``scale_sum`` within 1e-6 of their
    magnitude, as ``tests/test_torch_reliability.py`` holds them (float32
    sums in another order)."""
    assert isinstance(a, DensePlan) and isinstance(b, DensePlan)
    for f in ("values", "scale", "planes", "padded_scale"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.bits, a.k, a.n) == (b.bits, b.k, b.n)
    assert a.cfg.abft_tag == b.cfg.abft_tag
    assert (a.abft is None) == (b.abft is None)
    if a.abft is None:
        return
    assert sorted(a.abft) == sorted(b.abft)
    assert torch.equal(a.abft["col_i32"], b.abft["col_i32"])
    mag = {"col_f32": (a.values.abs().float() * a.scale).sum(-1),
           "scale_sum": a.scale.sum((-2, -1))}
    for name, scale in mag.items():
        gap = (a.abft[name] - b.abft[name]).abs()
        assert torch.equal(a.abft[name], b.abft[name]) if float_sums_exact \
            else bool((gap <= 1e-6 * scale + 1e-12).all()), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_plan_params_for_pim_bit_exact(arch):
    """Codes, scales, planes, ABFT records and tags of every planned
    projection, ``enc_layers`` and ``layers/xattn`` included, equal JAX's
    (verify "always"); every other leaf (norms, the fake-quantized
    embedding and ``vproj_dh``) equals JAX's bit for bit."""
    jcfg, tcfg, jp, tp = _model(arch)
    jplanned = j_serve.plan_params_for_pim(jp, JPimConfig(
        weight_bits=4, act_bits=4, substrate="exact-jnp", verify="always"))
    tplanned = t_serve.plan_params_for_pim(tp, PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-torch", verify="always"))
    converted = convert.planned_params_from_reference(jplanned, "cpu")
    mine, theirs = dict(_plans(tplanned)), dict(_plans(converted))
    assert sorted(mine) == sorted(theirs)
    for path, plans in mine.items():
        assert len(plans) == 2
        for i, (a, b) in enumerate(zip(plans, theirs[path])):
            _same_plan(a, b, float_sums_exact=False)
            assert a.cfg.abft_tag == "/".join(path), (path, i)
    stacks = {p[0] for p in mine}
    blocks = {p[:2] for p in mine}
    if jcfg.encoder_layers:
        assert stacks == {"layers", "enc_layers"}
        assert blocks == {("layers", "attn"), ("layers", "xattn"),
                          ("layers", "mlp"), ("enc_layers", "attn"),
                          ("enc_layers", "mlp")}
        assert len(mine) == 4 + 4 + 2 + 4 + 2
    else:
        assert blocks == {("layers", "attn"), ("layers", "mlp")}
        assert len(mine) == 4 + 3
        assert torch.equal(tplanned["vproj_dh"], converted["vproj_dh"])
        assert not torch.equal(tplanned["vproj_dh"], tp["vproj_dh"])
    for a, b in zip(leaves({k: v for k, v in tplanned.items()
                            if k not in ("layers", "enc_layers")}),
                    leaves({k: v for k, v in converted.items()
                            if k not in ("layers", "enc_layers")})):
        assert torch.equal(a, b)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_plan(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_program_equals_plan_params_of_init_lm(arch):
    """Serving's set-up programs each layer of both stacks as it is drawn
    (the encoder's too, tagged ``enc_layers/...``, never fake-quantized as
    a whole stack) and fake-quantizes ``vproj_dh``: equal to
    ``plan_params_for_pim(init_lm(...))`` bit for bit."""
    _, cfg, _, _ = _model(arch)
    pim_cfg = PimConfig(weight_bits=4, act_bits=4, substrate="exact-torch",
                        verify="always")
    got = t_serve._program(cfg, pim_cfg, "cpu")
    want = t_serve.plan_params_for_pim(t_lm.init_lm(cfg, 0, device="cpu"),
                                       pim_cfg)
    _same_tree(got, want)
    if cfg.encoder_layers:
        assert isinstance(got["enc_layers"]["attn"]["wq_dh"], list)
        assert got["enc_layers"]["mlp"]["wi_dh"][1].cfg.abft_tag == \
            "enc_layers/mlp/wi_dh"


def test_params_digest_keeps_the_stacks_apart():
    """The plan directory's digest hashes the encoder's leaves under their
    own keys: it changes when only an encoder layer's weights change."""
    _, cfg, _, _ = _model("whisper-medium")
    base = t_serve._params_digest(cfg, "cpu")
    assert base == t_serve._params_digest(cfg, "cpu")
    shallower = dataclasses.replace(cfg, encoder_layers=1)
    assert t_serve._params_digest(shallower, "cpu") != base


@pytest.mark.parametrize("arch", FAMILIES)
def test_request_inputs_draw_as_jax_serve(arch):
    """serve's request: tokens, then patches, then frames (as long as the
    prompt) from one ``default_rng(0)``, as ``repro/launch/serve.py``
    draws them."""
    _, cfg, _, _ = _model(arch)
    tokens, inputs = t_serve.request_inputs(cfg, 3, 7, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        tokens.numpy(), rng.integers(0, cfg.vocab_size, size=(3, 7)))
    want = {}
    if cfg.vision_tokens:
        want["patches"] = np.asarray(jnp.asarray(rng.standard_normal(
            (3, cfg.vision_tokens, cfg.vision_dim)), jnp.float32))
    if cfg.encoder_layers:
        want["frames"] = np.asarray(jnp.asarray(rng.standard_normal(
            (3, 7, cfg.d_model)), jnp.float32))
    assert sorted(inputs) == sorted(want) and len(want) == 1
    for k, v in want.items():
        assert inputs[k].dtype == torch.float32
        np.testing.assert_array_equal(inputs[k].numpy(), v)


@pytest.mark.parametrize("arch", FAMILIES)
def test_static_loop_matches_jax_serve_loop(arch):
    """The static loop on JAX's plans (``exact-jnp``, converted to
    ``exact-torch``) against JAX's serve loop run eagerly: ``max_len`` =
    prompt + prefix + gen and decode step g at prompt + prefix + g. The
    prefill logits within MATMUL, the greedy tokens equal."""
    jcfg, tcfg, jp, _ = _model(arch)
    jplanned = j_serve.plan_params_for_pim(jp, JPimConfig(
        weight_bits=4, act_bits=4, substrate="exact-jnp"))
    tplanned = convert.planned_params_from_reference(jplanned, "cpu")
    tokens, inputs = t_serve.request_inputs(tcfg, B, S, "cpu")
    jbatch = {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)}
    jbatch.update({k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
    start = S + _prefix(jcfg)
    jl, cache = j_lm.prefill(jplanned, jcfg, jbatch, max_len=start + GEN)
    first, want = jl, []
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for g in range(GEN):
        want.append(np.asarray(tok))
        jl, cache = j_lm.decode_step(jplanned, jcfg, cache, tok,
                                     jnp.int32(start + g))
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    generated, _, _, logits = t_serve.static_loop(tplanned, tcfg, tokens,
                                                  GEN, inputs=inputs)
    np.testing.assert_allclose(_t(logits), _np(first), **MATMUL)
    np.testing.assert_array_equal(generated.numpy(),
                                  np.concatenate(want, axis=1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_entry_point(arch):
    """``serve`` itself at 2 layers, d_model 64, on the CPU: greedy tokens
    of the requested shape, equal to the static loop on the programmed
    tree."""
    res = t_serve.serve(arch, batch=2, prompt_len=8, gen=3, layers=2,
                        d_model=64, pim=True, device="cpu")
    assert res["generated"].shape == (2, 3)
    cfg = get_config(arch).reduced(num_layers=2, d_model=64, vocab=512)
    planned = t_serve._program(cfg, PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-cuda"), "cpu")
    tokens, inputs = t_serve.request_inputs(cfg, 2, 8, "cpu")
    generated, _, _, _ = t_serve.static_loop(planned, cfg, tokens, 3,
                                             inputs=inputs)
    np.testing.assert_array_equal(generated.numpy(), res["generated"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_train_step_match_jax(arch):
    """``lm_loss`` on a data-pipeline batch (patches or frames included;
    paligemma's prefix logits dropped) and one AdamW step from one
    converted state, the port at ``attn_backend="pallas"`` (the flash
    route's plain version): the loss, gradient norm and lr, and the
    parameters after the step."""
    jcfg, tcfg, jp, _ = _model(arch)
    tcfg = dataclasses.replace(tcfg, attn_backend="pallas")
    dcfg = j_data.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                             global_batch=2)
    batch = j_data.lm_batch(dcfg, jcfg, 0)
    assert ("patches" in batch) == bool(jcfg.vision_tokens)
    assert ("frames" in batch) == bool(jcfg.encoder_layers)
    jst = {"params": jp, "opt": j_adamw.adamw_init(jp),    # init_state's
           "step": jnp.zeros((), jnp.int32)}
    tst = convert.train_state_from_reference(
        jax.tree.map(np.asarray, jst), "cpu")
    tbatch = t_train.batch_to_device(batch, "cpu")
    tloss, metrics = t_train.lm_loss(tst["params"], tcfg, tbatch)
    assert float(metrics["loss"]) == float(tloss)
    # JAX's step reports its lm_loss as "loss"
    jst, jm = j_train.make_train_step(jcfg, j_adamw.AdamWConfig(**OPT))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jm["loss"]), **SCALAR)
    tst, tm = t_train.make_train_step(tcfg, t_adamw.AdamWConfig(**OPT))(
        tst, tbatch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **SCALAR)
    assert float(tm["lr"]) == float(jm["lr"])
    fine = total = 0
    for w, g in zip(jax.tree.leaves(jst["params"]), leaves(tst["params"])):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= PARAM_ATOL, diff.max()
        fine += int((diff > PARAM_FINE).sum())
        total += diff.size
    assert fine <= PARAM_SHARE * total, (fine, total)


# ---------------------------------------------------------------------------
# meshes: the entry points take both families (the split routes run on
# gloo ranks in tests/test_torch_mesh.py and tests/test_torch_train_mesh.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_entry_points_take_the_family(arch):
    """serve --mesh, the engine's plan placement and the sharded train step
    run both families, with no refusal of the family: on a one-rank mesh
    (no process group) the served tokens, the placed plans and one train
    step equal the single-device ones bit for bit, and a mesh larger than
    the world raises naming the torchrun line."""
    jcfg, cfg, jp, tp = _model(arch)
    kw = dict(layers=2, d_model=64, pim=True, device="cpu",
              pim_substrate="exact-torch")
    one = t_serve.serve(arch, mesh="1,1", **kw)
    assert one["mesh"] == "1,1"
    np.testing.assert_array_equal(one["generated"],
                                  t_serve.serve(arch, **kw)["generated"])
    mesh = t_launch_mesh.make_serve_mesh("1,1", "cpu")
    planned = t_serve.plan_params_for_pim(tp, PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-torch"))
    placed, replicated = t_engine_mesh.place_plan_tree(planned, mesh)
    assert replicated == []
    plans = [p for _, p in flatten_with_path(placed)
             if isinstance(p, DensePlan)]
    assert plans and all(p.shard is None for p in plans)
    batch = t_train.batch_to_device(j_data.lm_batch(j_data.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2), jcfg, 0),
        "cpu")
    steps = []
    for m in (None, mesh):
        state = convert.train_state_from_reference(jax.tree.map(
            np.asarray, {"params": jp, "opt": j_adamw.adamw_init(jp),
                         "step": jnp.zeros((), jnp.int32)}), "cpu")
        state, metrics = t_train.make_train_step(
            cfg, t_adamw.AdamWConfig(**OPT), mesh=m)(state, batch)
        steps.append((metrics, state))
    for key in ("loss", "grad_norm"):
        assert float(steps[0][0][key]) == float(steps[1][0][key]), key
    for a, b in zip(leaves(steps[0][1]["params"]),
                    leaves(steps[1][1]["params"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="torchrun --standalone "
                       "--nproc-per-node 2"):
        t_train.train_loop(arch, steps=1, layers=2, d_model=64,
                           device="cpu", mesh="1,2")
