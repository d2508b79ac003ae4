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
