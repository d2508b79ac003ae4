"""Quantization parity: the port's codes, scales and nibble planes equal
the JAX reference's bit for bit at 4 and 8 bits, including exact .5 ties
and all-zero rows. Inputs are made with numpy from a seed and handed to
both packages."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro.quant re-exports a function named ``quantize``: import the modules
jq = importlib.import_module("repro.quant.quantize")
jnib = importlib.import_module("repro.quant.nibbles")
tq = importlib.import_module("repro_torch.quant.quantize")
tnib = importlib.import_module("repro_torch.quant.nibbles")

BITS = (4, 8)


def _inputs(bits, seed=0):
    """Random rows, a row of exact .5 ties (amax = qmax, so scale == 1),
    and an all-zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 24)).astype(np.float32) * 3.0
    qm = jq.qmax(bits)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5],
                    dtype=np.float32)
    x[1] = 0.0
    x[1, :8] = ties
    x[1, 8] = qm                       # abs-max -> scale exactly 1.0
    x[3] = 0.0                         # all-zero row -> eps-floored scale
    return x


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", (None, (0,), (1,)))
def test_codes_and_scales_bit_exact(bits, axis):
    x = _inputs(bits)
    ref = jq.quantize(jnp.asarray(x), bits=bits, axis=axis)
    got = tq.quantize(torch.from_numpy(x), bits=bits, axis=axis)
    assert got.values.dtype == torch.int8 and got.bits == bits
    np.testing.assert_array_equal(_np(got.values), _np(ref.values))
    np.testing.assert_array_equal(_np(got.scale), _np(ref.scale))
    np.testing.assert_array_equal(_np(got.dequantize()),
                                  _np(ref.dequantize()))
    if axis == (1,):
        # the tie row really holds ties, rounded to even like jnp.round
        np.testing.assert_array_equal(_np(got.values)[1, :8],
                                      [0, 2, 2, 0, -2, -2, 4, -4])
        assert (_np(got.values)[3] == 0).all()


@pytest.mark.parametrize("bits", BITS)
def test_depthwise_axis_and_dynamic_activations(bits):
    rng = np.random.default_rng(1)
    x3 = rng.standard_normal((5, 9, 12)).astype(np.float32)
    x3[2] = 0.0
    ref = jq.quantize(jnp.asarray(x3), bits=bits, axis=(1,))
    got = tq.quantize(torch.from_numpy(x3), bits=bits, axis=(1,))
    np.testing.assert_array_equal(_np(got.values), _np(ref.values))
    np.testing.assert_array_equal(_np(got.scale), _np(ref.scale))
    ref_d = jq.dynamic_quantize_activations(jnp.asarray(x3), bits)
    got_d = tq.dynamic_quantize_activations(torch.from_numpy(x3), bits)
    np.testing.assert_array_equal(_np(got_d.values), _np(ref_d.values))
    np.testing.assert_array_equal(_np(got_d.scale), _np(ref_d.scale))


@pytest.mark.parametrize("bits", BITS)
def test_nibble_planes_bit_exact(bits):
    x = _inputs(bits, seed=2)
    codes = np.asarray(jq.quantize(jnp.asarray(x), bits=bits,
                                   axis=(0,)).values)
    ref = jnib.to_nibbles(jnp.asarray(codes), bits)
    got = tnib.to_nibbles(torch.from_numpy(codes.copy()), bits)
    assert got.shape == (tnib.num_nibbles(bits),) + codes.shape
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(_np(tnib.from_nibbles(got)),
                                  _np(jnib.from_nibbles(ref)))
    np.testing.assert_array_equal(_np(tnib.from_nibbles(got)), codes)


def test_nibble_pack_unpack_bit_exact():
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 16, size=(7, 11)).astype(np.uint8)
    hi = rng.integers(0, 16, size=(7, 11)).astype(np.uint8)
    ref = jnib.pack_nibble_pair(jnp.asarray(lo), jnp.asarray(hi))
    got = tnib.pack_nibble_pair(torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(_np(got), _np(ref))
    for g, r in zip(tnib.unpack_nibble_pair(got),
                    jnib.unpack_nibble_pair(ref)):
        np.testing.assert_array_equal(_np(g), _np(r))
    assert [tnib.num_nibbles(b) for b in (1, 4, 5, 8, 16)] == \
        [jnib.num_nibbles(b) for b in (1, 4, 5, 8, 16)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", (None, (0,)))
def test_fake_quantize_forward_and_ste_gradient(bits, axis):
    x = _inputs(bits, seed=4)
    ref = jq.fake_quantize(jnp.asarray(x), bits, axis)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq.fake_quantize(xt, bits, axis)
    np.testing.assert_array_equal(_np(got), _np(ref))
    # the STE gradient is the in-range mask, identical in both packages
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    ref_g = jax.grad(lambda v: jnp.sum(jq.fake_quantize(v, bits, axis)
                                       * w))(jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), _np(ref_g))


@pytest.mark.parametrize("bits", BITS)
def test_quantization_mse(bits):
    x = np.random.default_rng(6).standard_normal((16, 32)).astype(
        np.float32)
    ref = float(jq.quantization_mse(jnp.asarray(x), bits))
    got = float(tq.quantization_mse(torch.from_numpy(x), bits))
    # the reference is jit-compiled, so its mean may sum in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert tq.qmax(bits) == jq.qmax(bits)


# ---------------------------------------------------------------------------
# The substrate glue around the fused activation quantizer: its plain route
# on the CPU, padding, the kernel's launch geometry and the keyed span (the
# kernel itself runs on the card: tests/test_torch_cuda_kernels.py)
# ---------------------------------------------------------------------------
jpim = importlib.import_module("repro.core.pim")
tpim = importlib.import_module("repro_torch.core.pim")
aq = importlib.import_module("repro_torch.kernels.act_quant.act_quant")
trace = importlib.import_module("repro_torch.analysis.trace")


def _plan(k, n, bits):
    w = np.random.default_rng(k).standard_normal((k, n)).astype(np.float32)
    cfg = tpim.PimConfig(weight_bits=bits, act_bits=bits,
                         substrate="exact-cuda")
    return tpim.prepare_weights(torch.from_numpy(w), cfg)


@pytest.mark.parametrize("padded", (False, True), ids=("k", "kp"))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", (24, 27, 576))
def test_quantize_activations_plain_route_equals_jax(k, bits, padded):
    """``_quantize_activations`` on CPU rows (the plain route; a width is
    the kernel route's alone) + ``_pad_act_planes`` give the JAX
    package's codes, scales and planes, padded to the plan's K or not,
    ties and zero rows included."""
    x = np.random.default_rng(k).standard_normal((6, k)).astype(
        np.float32) * 3.0
    x[:, :24] = _inputs(bits)
    plan = _plan(k, 16, bits)
    kp = plan.planes.shape[1]
    a_q, planes = tpim._quantize_activations(torch.from_numpy(x), plan.cfg,
                                             kp if padded else None)
    assert planes.shape == (tnib.num_nibbles(bits), 6, k)
    if padded:
        planes = tpim._pad_act_planes(planes, plan)
    width = kp if padded else k
    cfg = jpim.PimConfig(weight_bits=bits, act_bits=bits)
    j_q, j_planes = jpim._quantize_activations(jnp.asarray(x), cfg)
    j_planes = np.pad(np.asarray(j_planes), ((0, 0), (0, 0), (0, width - k)))
    np.testing.assert_array_equal(_np(a_q.values), _np(j_q.values))
    np.testing.assert_array_equal(_np(a_q.scale), _np(j_q.scale))
    np.testing.assert_array_equal(_np(planes), j_planes)


def test_pad_act_planes_pads_from_the_current_width():
    """Planes already at the plan's K come back as they are; narrower
    ones are padded with zeros from their own width."""
    plan = _plan(576, 16, 4)
    kp = plan.planes.shape[1]
    assert kp == 1024
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 576)).astype(np.float32))
    _, planes = tpim._quantize_activations(x, plan.cfg)
    padded = tpim._pad_act_planes(planes, plan)
    assert padded.shape == (1, 5, kp)
    assert torch.equal(padded[..., :576], planes)
    assert not padded[..., 576:].any()
    assert tpim._pad_act_planes(padded, plan) is padded
    part = torch.nn.functional.pad(planes, (0, 800 - 576))
    assert torch.equal(tpim._pad_act_planes(part, plan), padded)


# (M, K, vec) -> (group, rows): the group is the least power of two whose
# threads hold the row in ITEMS loads (K = 32 / 33 / 64 / 65 at vec 4,
# 8 / 9 at vec 1), capped at MAX_GROUP (K = 16384 / 16385); blocks of 256
# threads hold several rows unless that leaves fewer blocks than SMs
# (M = 132 * 64 / 131 * 64 at the stem's group of 4), down to one warp
GRID_CASES = (
    ((131072, 27, 1), (4, 64)), ((131072, 576, 4), (32, 8)),
    ((32768, 64, 4), (2, 128)), ((4096, 2560, 4), (128, 2)),
    ((4096, 9728, 4), (512, 1)), ((8, 2560, 4), (128, 1)),
    ((8, 9728, 4), (512, 1)), ((37, 333, 1), (64, 1)),
    ((131072, 32, 4), (1, 256)), ((131072, 33, 4), (2, 128)),
    ((131072, 64, 4), (2, 128)), ((131072, 65, 4), (4, 64)),
    ((131072, 8, 1), (1, 256)), ((131072, 9, 1), (2, 128)),
    ((131072, 16384, 4), (512, 1)), ((131072, 16385, 4), (512, 1)),
    ((132 * 64, 27, 1), (4, 64)), ((131 * 64, 27, 1), (4, 32)),
    ((1, 27, 1), (4, 8)), ((1, 4, 4), (1, 32)), ((3, 576, 4), (32, 1)),
    ((300, 64, 4), (2, 16)))


@pytest.mark.parametrize("mkv,want", GRID_CASES,
                         ids=[f"{m}x{k}v{v}" for (m, k, v), _ in GRID_CASES])
def test_quant_grid_boundaries(mkv, want):
    m, k, vec = mkv
    group, rows = aq.quant_grid(m, k, vec)
    assert (group, rows) == want
    block = group * rows
    assert group & (group - 1) == 0 and block % 32 == 0 and \
        block <= aq.MAX_GROUP
    assert group * aq.ITEMS * vec >= k or group == aq.MAX_GROUP


def test_quant_grid_invariants_over_shapes():
    """Every (M, K) gives a launch the C entry point takes: a power-of-two
    group, whole warps, at most MAX_GROUP threads, every row covered."""
    for vec in (1, 4):
        for k in list(range(1, 300)) + [576, 1152, 4608, 9728, 20000]:
            for m in (1, 7, 131, 4096, 131072):
                group, rows = aq.quant_grid(m, k, vec)
                block = group * rows
                assert group & (group - 1) == 0 and rows >= 1
                assert block % 32 == 0 and 32 <= block <= aq.MAX_GROUP
                assert group * aq.ITEMS * vec >= k or \
                    group == aq.MAX_GROUP


def test_act_quant_cuda_refuses_cpu_rows():
    """The kernel has no CPU mode: CPU rows raise, whatever their dtype or
    layout, and launch nothing (``_quantize_activations`` sends them to
    the plain route)."""
    x = torch.ones((4, 8))
    before = aq.LAUNCHES["act_quant"]
    for t, bits in ((x, 4), (x, 8), (x.t(), 4), (x.double(), 4)):
        with pytest.raises(ValueError, match="takes float32 or bfloat16"):
            aq.act_quant_cuda(t, bits)
    assert aq.LAUNCHES["act_quant"] == before


@pytest.fixture
def _disarmed():
    armed = trace._ARMED
    for r in reversed(armed):
        r.__exit__(None, None, None)
    yield
    for r in armed:
        r.__enter__()


def _eager_padded(x2, bits, width=None):
    """The eager steps and the padding, outside any span: the stand-in of
    the kernel's launch."""
    a_q = tq.quantize(x2, bits=bits, axis=(1,))
    planes = tnib.to_nibbles(a_q.values, bits)
    if width is not None:
        planes = torch.nn.functional.pad(planes, (0, width - x2.shape[1]))
    return a_q.values, a_q.scale, planes


@pytest.mark.parametrize("route", ("plain", "kernel"))
def test_quantize_span_counts_once_per_call_by_route(_disarmed,
                                                     monkeypatch, route):
    """Each ``_quantize_activations`` call is one ``pim.quantize`` span
    under its route's key; the plain route also enters ``pim.nibbles``,
    the kernel route (its device check and launch stood in for here by
    the eager steps) does not, takes the plan's width, and leaves
    ``_pad_act_planes`` nothing to pad. The exact-cuda matmul gives the
    same bits on both."""
    plan = _plan(576, 16, 4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 576)).astype(np.float32))
    want = tpim.exact_cuda_matmul2d(x, plan, plan.cfg)
    widths = []
    if route == "kernel":
        def stand_in(x2, bits, width=None):
            widths.append(width)
            return _eager_padded(x2, bits, width)
        monkeypatch.setattr(tpim, "on_cuda", lambda *t: True)
        monkeypatch.setattr(aq, "act_quant_cuda", stand_in)
    with trace.Recorder() as rec:
        got = tpim.exact_cuda_matmul2d(x, plan, plan.cfg)
        tpim._quantize_activations(x, plan.cfg)
    assert torch.equal(got, want)
    agg = rec.aggregate("pim.quantize")
    assert set(agg) == {route} and agg[route][0] == 2
    assert sum(c for c, _ in rec.aggregate("pim.nibbles").values()) == \
        (2 if route == "plain" else 0)
    assert sum(c for c, _ in rec.aggregate("pim.pad").values()) == 1
    if route == "kernel":
        assert widths == [plan.planes.shape[1], None]
