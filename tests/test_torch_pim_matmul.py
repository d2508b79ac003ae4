"""PIM matmul parity: the port's ``ops`` entry points (on the CPU, their
plain versions) against the JAX package's Pallas kernels run in interpret
mode, at ragged shapes, w4a4, w8a8 and mixed widths. The int32
accumulator and the row-sums match bit for bit; the float32 output
matches bit for bit without a bias, and with one within the gap between
an FMA and two roundings (the JAX kernel runs under jit, where XLA may
contract the bias add into an FMA)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pim_matmul import ops as jops
from repro.kernels.pim_matmul.pim_matmul import (kernel_tiles as j_tiles,
                                                 pim_matmul_fused_pallas,
                                                 pim_matmul_pallas)
from repro.quant.quantize import quantize as j_quantize
from repro_torch.kernels.pim_matmul import ops
from repro_torch.kernels.pim_matmul.pim_matmul import LAUNCHES
from repro_torch.kernels.pim_matmul.pim_matmul import \
    kernel_tiles as t_tiles

SHAPES = ((5, 7, 3), (37, 333, 77), (130, 520, 130))
PLANES = ((1, 1), (1, 2), (2, 2))


def _inputs(pa, pw, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, size=(pa, m, k)).astype(np.int8)
    w = rng.integers(-15, 16, size=(pw, k, n)).astype(np.int8)
    a_s = (rng.random((m, 1)) + 0.05).astype(np.float32) / 7
    w_s = (rng.random((1, n)) + 0.05).astype(np.float32) / 7
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return a, w, a_s, w_s, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int32_accumulator_bit_exact(pa, pw, m, k, n):
    a, w, _, _, _ = _inputs(pa, pw, m, k, n)
    ref = np.asarray(pim_matmul_pallas(jnp.asarray(a), jnp.asarray(w),
                                       interpret=True))
    got = ops.pim_matmul_int(*_t(a, w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fused_epilogue_and_rowsums(pa, pw, m, k, n):
    a, w, a_s, w_s, bias = _inputs(pa, pw, m, k, n, seed=1)
    ja = [jnp.asarray(v) for v in (a, w, a_s, w_s, bias)]
    ta = _t(a, w, a_s, w_s, bias)
    # no bias: bit for bit, row-sums included
    ref, ref_rs = pim_matmul_fused_pallas(*ja[:4], interpret=True,
                                          want_rowsum=True)
    got, got_rs = ops.pim_matmul_fused(*ta[:4], want_rowsum=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(ref_rs))
    assert got_rs.dtype == torch.int32
    # with a bias: the port rounds the product, then the sum (as its CUDA
    # epilogue does, bit for bit); the jitted reference may fuse the last
    # multiply and the add into one FMA. The two differ by at most half an
    # ulp of the product plus one ulp of the result — more than 1 ulp of
    # the result where the bias cancels most of the product
    ref_b = np.asarray(pim_matmul_fused_pallas(*ja, interpret=True))
    got_b = ops.pim_matmul_fused(*ta).numpy()
    prod = got.numpy()
    tol = 0.5 * np.spacing(np.abs(prod)) + np.spacing(np.abs(ref_b))
    assert (np.abs(got_b - ref_b) <= tol).all()
    # and the plain route is the same arithmetic as the reference's oracle
    np.testing.assert_array_equal(
        got_b, np.asarray(jops.pim_matmul_fused(*ja, use_ref=True)))


def test_rowsums_wrap_like_int32():
    """Full-range int8 planes (fault injection can write any int8) make
    the row-sums overflow int32: both packages wrap mod 2^32."""
    rng = np.random.default_rng(2)
    a = rng.integers(100, 128, size=(2, 9, 640)).astype(np.int8)
    w = rng.integers(100, 128, size=(2, 640, 40)).astype(np.int8)
    a_s = np.ones((9, 1), np.float32)
    w_s = np.ones((1, 40), np.float32)
    _, ref_rs = pim_matmul_fused_pallas(
        *[jnp.asarray(v) for v in (a, w, a_s, w_s)], interpret=True,
        want_rowsum=True)
    _, got_rs = ops.pim_matmul_fused(*_t(a, w, a_s, w_s), want_rowsum=True)
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(ref_rs))
    np.testing.assert_array_equal(
        ops.pim_matmul_int(*_t(a, w)).numpy(),
        np.asarray(pim_matmul_pallas(jnp.asarray(a), jnp.asarray(w),
                                     interpret=True)))


@pytest.mark.parametrize("bits", (4, 8))
def test_quantized_entry_point(bits):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 11, 96)).astype(np.float32)
    wf = rng.standard_normal((96, 40)).astype(np.float32)
    w_q = j_quantize(jnp.asarray(wf), bits=bits, axis=(0,))
    # the reference's body run eagerly: under jit, some per-row scales
    # round differently from the eager (op-by-op IEEE) ones
    ref = jops.pim_matmul_quantized.__wrapped__(
        jnp.asarray(x), w_q.values, w_q.scale, weight_bits=bits,
        act_bits=bits, interpret=True)
    got = ops.pim_matmul_quantized(
        torch.from_numpy(x), torch.from_numpy(np.asarray(w_q.values).copy()),
        torch.from_numpy(np.asarray(w_q.scale).copy()), weight_bits=bits,
        act_bits=bits)
    assert tuple(got.shape) == (3, 11, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_version():
    a, w, a_s, w_s, bias = _t(*_inputs(1, 1, 8, 16, 4))
    before = dict(LAUNCHES)
    ops.pim_matmul_fused(a, w, a_s, w_s, bias)
    ops.pim_matmul_int(a, w)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="one device"):
        ops.pim_matmul_int(a, w.to("meta"))


@pytest.mark.parametrize("m,k,n", ((1, 27, 64), (300, 1024, 100),
                                   (8, 4608, 512), (129, 513, 129)))
def test_kernel_tiles_match_reference(m, k, n):
    assert t_tiles(m, k, n) == j_tiles(m, k, n)
