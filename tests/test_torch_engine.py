"""Engine parity: the port's ``engine.program`` / ``engine.matmul`` against
the JAX package's eager ``exact-jnp`` route, bit for bit, for dense and
depthwise plans at w4a4 and w8a8; plans programmed by JAX and converted
execute bit-identically in the port; the port's own programming gives the
same codes, scales and planes as JAX's; registry and guard behaviour."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import pim as jpim
from repro_torch import convert
from repro_torch import engine
from repro_torch.core import pim

PORT_EXACT = ("exact-cuda", "exact-torch")
BITS = ((4, 4), (8, 8))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jcfg(wb, ab, substrate="exact-jnp"):
    return jpim.PimConfig(weight_bits=wb, act_bits=ab, substrate=substrate)


def _tcfg(wb, ab, substrate):
    return pim.PimConfig(weight_bits=wb, act_bits=ab, substrate=substrate)


@pytest.mark.parametrize("with_bias", (False, True))
@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("substrate", PORT_EXACT)
def test_dense_matmul_matches_jax_bit_exact(substrate, wb, ab, with_bias):
    x, w, b = _rand((16, 96), 0), _rand((96, 40), 1), _rand((40,), 2)
    jplan = jengine.program(jnp.asarray(w), _jcfg(wb, ab))
    ref = jengine.matmul(jnp.asarray(x), jplan,
                         bias=jnp.asarray(b) if with_bias else None)
    plan = engine.program(torch.from_numpy(w), _tcfg(wb, ab, substrate))
    assert isinstance(plan, pim.DensePlan) and plan.substrate == substrate
    got = engine.matmul(torch.from_numpy(x), plan,
                        bias=torch.from_numpy(b) if with_bias else None)
    np.testing.assert_array_equal(_np(got), _np(ref))
    if not with_bias:
        np.testing.assert_array_equal(
            _np(pim.reference_quantized_matmul(torch.from_numpy(x), plan,
                                               plan.cfg)),
            _np(jpim.reference_quantized_matmul(jnp.asarray(x), jplan,
                                                jplan.cfg)))


@pytest.mark.parametrize("wb,ab", BITS + ((4, 8), (8, 4)))
def test_port_substrates_agree_on_nd_inputs(wb, ab):
    x, w = _rand((3, 11, 200), 3), _rand((200, 72), 4)
    outs = [engine.matmul(torch.from_numpy(x),
                          engine.program(torch.from_numpy(w),
                                         _tcfg(wb, ab, s)))
            for s in PORT_EXACT]
    assert tuple(outs[0].shape) == (3, 11, 72)
    assert torch.equal(outs[0], outs[1])
    ref = jengine.matmul(jnp.asarray(x),
                         jengine.program(jnp.asarray(w), _jcfg(wb, ab)))
    np.testing.assert_array_equal(_np(outs[0]), _np(ref))


@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("substrate", PORT_EXACT)
def test_depthwise_matmul_matches_jax_bit_exact(substrate, wb, ab):
    cols, w = _rand((50, 9, 12), 5), _rand((9, 12), 6)
    cols[3] = 0.0                                  # an all-zero patch row
    jplan = jengine.program(jnp.asarray(w), _jcfg(wb, ab), kind="depthwise")
    ref = jengine.matmul(jnp.asarray(cols), jplan)
    plan = engine.program(torch.from_numpy(w), _tcfg(wb, ab, substrate),
                          kind="depthwise")
    assert isinstance(plan, pim.DepthwisePlan)
    got = engine.matmul(torch.from_numpy(cols), plan)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("wb", (4, 8))
@pytest.mark.parametrize("k,n", ((27, 64), (600, 100), (96, 40)))
def test_programming_matches_jax(wb, k, n):
    """Codes, scales, padded planes and the padding contract are the same
    as JAX's (K pads to kernel_tiles' bk and to a WDM-chunk boundary)."""
    w = _rand((k, n), 7)
    jplan = jengine.program(jnp.asarray(w), _jcfg(wb, wb))
    plan = engine.program(torch.from_numpy(w), _tcfg(wb, wb, "exact-cuda"))
    for field in ("values", "scale", "planes", "padded_scale"):
        np.testing.assert_array_equal(_np(getattr(plan, field)),
                                      _np(getattr(jplan, field)))
    assert (plan.bits, plan.k, plan.n) == (jplan.bits, jplan.k, jplan.n)
    jdw = jengine.program(jnp.asarray(w[:9]), _jcfg(wb, wb),
                          kind="depthwise")
    dw = engine.program(torch.from_numpy(w[:9]), _tcfg(wb, wb, "exact-cuda"),
                        kind="depthwise")
    for field in ("values", "scale", "planes"):
        np.testing.assert_array_equal(_np(getattr(dw, field)),
                                      _np(getattr(jdw, field)))


@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("jax_substrate,port_substrate", (
    ("exact-pallas", "exact-cuda"), ("exact-jnp", "exact-torch")))
def test_converted_jax_plans_execute_bit_identically(jax_substrate,
                                                     port_substrate, wb, ab):
    x, w, b = _rand((21, 130), 8), _rand((130, 70), 9), _rand((70,), 10)
    cols, wd = _rand((30, 9, 5), 11), _rand((9, 5), 12)
    jplan = jengine.program(jnp.asarray(w), _jcfg(wb, ab, jax_substrate))
    jdw = jengine.program(jnp.asarray(wd), _jcfg(wb, ab, jax_substrate),
                          kind="depthwise")
    plan = convert.plan_from_reference(jplan, device="cpu")
    dw = convert.plan_from_reference(jdw, device="cpu")
    assert plan.substrate == port_substrate and dw.substrate == port_substrate
    jnp_cfg = _jcfg(wb, ab)          # eager oracle route for the reference
    ref = jengine.matmul(jnp.asarray(x), jplan, cfg=jnp_cfg,
                         bias=jnp.asarray(b))
    got = engine.matmul(torch.from_numpy(x), plan, bias=torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(
        _np(engine.matmul(torch.from_numpy(cols), dw)),
        _np(jengine.matmul(jnp.asarray(cols), jdw, cfg=jnp_cfg)))


def test_emulate_matches_jax():
    x, w = _rand((8, 48), 13), _rand((48, 24), 14)
    jplan = jengine.program(jnp.asarray(w), _jcfg(4, 4, "emulate"))
    plan = engine.program(torch.from_numpy(w), _tcfg(4, 4, "emulate"))
    # float32 products sum in another order in the two libraries
    np.testing.assert_allclose(
        _np(engine.matmul(torch.from_numpy(x), plan)),
        _np(jengine.matmul(jnp.asarray(x), jplan)), rtol=1e-6, atol=1e-6)
    cols, wd = _rand((6, 9, 4), 15), _rand((9, 4), 16)
    jdw = jengine.program(jnp.asarray(wd), _jcfg(4, 4, "emulate"),
                          kind="depthwise")
    dw = engine.program(torch.from_numpy(wd), _tcfg(4, 4, "emulate"),
                        kind="depthwise")
    np.testing.assert_allclose(
        _np(engine.matmul(torch.from_numpy(cols), dw)),
        _np(jengine.matmul(jnp.asarray(cols), jdw)), rtol=1e-6, atol=1e-6)


def test_registry_and_aliases():
    assert engine.available_substrates() == ("analog", "analog-cuda",
                                             "emulate", "exact-cuda",
                                             "exact-torch")
    assert engine.get_substrate("exact-pallas").name == "exact-cuda"
    assert engine.get_substrate("exact-jnp").name == "exact-torch"
    assert pim.PimConfig().resolved_substrate == "exact-cuda"
    assert pim.PimConfig(substrate="exact-jnp").resolved_substrate == \
        "exact-torch"
    with pytest.raises(ValueError, match="unknown PIM substrate"):
        engine.get_substrate("nope")
    with pytest.raises(ValueError, match="unknown plan kind"):
        engine.program(torch.zeros(4, 4), kind="nope")

    class Doubling(engine.Substrate):
        name = "test-doubling"

        def _dense2d(self, x2, plan, cfg, bias, rng):
            return 2 * pim.exact_torch_matmul2d(x2, plan, cfg, bias)

    engine.register_substrate(Doubling())
    x, w = torch.from_numpy(_rand((4, 8), 17)), torch.from_numpy(
        _rand((8, 3), 18))
    plan = engine.program(w, pim.PimConfig(substrate="test-doubling"))
    ref = engine.matmul(x, plan, cfg=pim.PimConfig(substrate="exact-torch"))
    assert torch.equal(engine.matmul(x, plan), 2 * ref)


def test_guards():
    w = torch.from_numpy(_rand((16, 8), 19))
    x = torch.from_numpy(_rand((2, 16), 20))
    plan = engine.program(w, pim.PimConfig(weight_bits=4))
    with pytest.raises(ValueError, match="programmed at 4 bits"):
        engine.matmul(x, plan, cfg=pim.PimConfig(weight_bits=8))
    with pytest.raises(NotImplementedError, match="<= 8 bits"):
        engine.matmul(x, plan, cfg=dataclasses.replace(plan.cfg,
                                                       act_bits=16))
    with pytest.raises(NotImplementedError, match="<= 8 bits"):
        engine.matmul(x, plan, cfg=pim.PimConfig(weight_bits=16))
    with pytest.raises(ValueError, match="contraction mismatch"):
        engine.matmul(x[:, :8], plan)
    dw = engine.program(w[:9], kind="depthwise")
    with pytest.raises(ValueError, match="no fused bias"):
        engine.matmul(torch.zeros(3, 9, 8), dw, bias=torch.zeros(8))
    with pytest.raises(NotImplementedError, match="reliability slice"):
        pim.PimConfig(verify="always")
    # wide weights still run on the float-only emulate route
    wide = engine.program(w, pim.PimConfig(weight_bits=16,
                                           substrate="emulate"))
    assert engine.matmul(x, wide).shape == (2, 8)


def test_config_conversion_and_plan_placement():
    jcfg = jpim.PimConfig(weight_bits=8, act_bits=4, adc_bits=6,
                          substrate="exact-pallas")
    cfg = convert.config_from_reference(jcfg)
    assert cfg == pim.PimConfig(weight_bits=8, act_bits=4, adc_bits=6,
                                substrate="exact-cuda")
    legacy = convert.config_from_reference(
        {**dataclasses.asdict(jpim.PimConfig()), "substrate": None,
         "use_pallas": False})
    assert legacy.resolved_substrate == "exact-torch"
    plan = engine.program(torch.from_numpy(_rand((12, 5), 21)))
    moved = plan.to("cpu")
    assert moved.cfg == plan.cfg and torch.equal(moved.planes, plan.planes)
    bf16 = np.asarray(jnp.asarray(_rand((3, 4), 22), dtype=jnp.bfloat16))
    t = convert.tensor_from_numpy(bf16, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  bf16.view(np.int16))
