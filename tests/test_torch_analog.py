"""Analog readout parity: the port's plain readout chain
(``kernels/analog_readout/ref.py``), its device-dispatching entry point
and the ``analog`` / ``analog-cuda`` substrates against the JAX package,
with numpy-made inputs; the noise rules; and the OPCM cell model.

The JAX side runs eagerly or in Pallas interpret mode, as
``tests/test_analog_kernel.py`` runs it. On the CPU every port route runs
the kernels' plain versions.

Tolerances: the deterministic chain is integer-exact up to one IEEE
divide and the epilogue's single roundings, so it is held bit for bit.
Against the jitted Pallas kernel with a bias, the reference may fuse the
last multiply and the bias add into one FMA: the two differ by at most
half an ulp of the product plus one ulp of the result. Noise cannot
match ``jax.random``'s bits; its statistics are held to 15% of the
standard deviation, as the reference's own noise test does.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import cell as jcell
from repro.core import pim as jpim
from repro.kernels.analog_readout import ops as jops
from repro.kernels.analog_readout.ref import (analog_fullscale_ref as
                                              jax_fullscale_ref)
from repro.kernels.analog_readout.ref import (analog_readout_fused_ref as
                                              jax_readout_ref)
from repro_torch import convert, engine
from repro_torch.core import cell, pim
from repro_torch.kernels.analog_readout import ops, ref

# (Pa, Pw, M, K, N): ragged, multi-pair, several K tiles, K below one
# chunk, K equal to one chunk
SHAPES = ((1, 1, 8, 32, 16), (2, 2, 100, 300, 70), (1, 2, 5, 37, 3),
          (2, 1, 8, 1024, 256), (1, 1, 1, 5, 1), (1, 1, 33, 8, 129))
SWEEP = ((4, 3), (8, 5), (16, 8))


def _planes(seed, pa, pw, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, size=(pa, m, k)).astype(np.int8)
    w = rng.integers(-15, 16, size=(pw, k, n)).astype(np.int8)
    a_s = (rng.random((m, 1)) * 0.99 + 0.01).astype(np.float32)
    w_s = (rng.random((1, n)) * 0.99 + 0.01).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return a, w, a_s, w_s, bias


def _both(arrays):
    return ([jnp.asarray(v) for v in arrays],
            [torch.from_numpy(v) for v in arrays])


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("chunk,adc", SWEEP)
@pytest.mark.parametrize("pa,pw,m,k,n", SHAPES)
def test_plain_chain_matches_jax_oracle(pa, pw, m, k, n, chunk, adc):
    """Both passes and the whole chain, with and without a bias, bit for
    bit (K below, at and above the chunk; ragged everything)."""
    j, t = _both(_planes(m + k + chunk, pa, pw, m, k, n))
    for with_bias in (False, True):
        b_j, b_t = (j[4], t[4]) if with_bias else (None, None)
        np.testing.assert_array_equal(
            ref.analog_readout_fused_ref(*t[:4], chunk, adc,
                                         bias=b_t).numpy(),
            np.asarray(jax_readout_ref(*j[:4], chunk, adc, bias=b_j)))
    fs = ref.analog_fullscale_ref(t[0], t[1], chunk)
    assert fs.dtype == torch.float32
    assert float(fs) == float(jax_fullscale_ref(j[0], j[1], chunk))


def test_folding_over_chunk_blocks_is_bit_identical(monkeypatch):
    """The plain version folds over blocks of chunks; any block size
    gives the same bits, noise included."""
    _, t = _both(_planes(1, 2, 2, 50, 96, 30))
    kw = dict(sigma=0.05, seed=3)
    whole = ref.analog_readout_fused_ref(*t[:4], 8, 5, **kw)
    for elems in (1, 50 * 30 * 3, 50 * 30 * 5):
        monkeypatch.setattr(ref, "BLOCK_ELEMS", elems)
        assert torch.equal(ref.analog_readout_fused_ref(*t[:4], 8, 5, **kw),
                           whole)


def test_all_zero_drive_takes_the_floor():
    j, t = _both(_planes(2, 1, 1, 6, 24, 5))
    j[0], t[0] = jnp.zeros_like(j[0]), torch.zeros_like(t[0])
    out = ref.analog_readout_fused_ref(*t[:4], 8, 5, bias=t[4])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_readout_ref(*j[:4], 8, 5, bias=j[4])))
    np.testing.assert_array_equal(out.numpy(), t[4].numpy().repeat(6, 0))
    lsb = ref.lsb_from_fullscale(ref.analog_fullscale_ref(t[0], t[1], 8), 5)
    assert float(lsb) == np.float32(np.float32(1e-6) * np.float32(1 / 15))


@pytest.mark.parametrize("pa,pw,m,k,n", ((2, 2, 100, 300, 70),
                                         (1, 2, 5, 37, 3)))
def test_entry_point_matches_jax_interpret_kernel(pa, pw, m, k, n):
    """The port's entry point (plain route on the CPU, K chunk-aligned by
    padding) against the jitted Pallas kernel in interpret mode."""
    j, t = _both(_planes(7, pa, pw, m, k, n))
    kw = dict(chunk=8, adc_bits=5)
    got = ops.analog_matmul_fused(*t[:4], **kw).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.analog_matmul_fused(*j[:4], interpret=True,
                                                 **kw)))
    ref_b = np.asarray(jops.analog_matmul_fused(*j[:4], None, j[4],
                                                interpret=True, **kw))
    got_b = ops.analog_matmul_fused(*t[:4], None, t[4], **kw).numpy()
    tol = 0.5 * np.spacing(np.abs(got)) + np.spacing(np.abs(ref_b))
    assert (np.abs(got_b - ref_b) <= tol).all()


def _jcfg(substrate, wb=4, ab=4, **kw):
    return jpim.PimConfig(weight_bits=wb, act_bits=ab, substrate=substrate,
                          **kw)


def _tcfg(substrate, wb=4, ab=4, **kw):
    return pim.PimConfig(weight_bits=wb, act_bits=ab, substrate=substrate,
                         **kw)


@pytest.mark.parametrize("with_bias", (False, True))
@pytest.mark.parametrize("wb,ab", ((4, 4), (8, 8)))
@pytest.mark.parametrize("m,k,n", ((16, 96, 40), (5, 37, 3), (8, 300, 70)))
def test_substrates_match_jax_analog(m, k, n, wb, ab, with_bias):
    """``analog`` and ``analog-cuda`` (port programming and plans
    converted from JAX's ``analog`` / ``analog-pallas``) against JAX's
    eager ``analog`` substrate, bit for bit (the port adds the bias with
    the same single rounding on both routes)."""
    x, w, b = _rand((m, k), m + k), _rand((k, n), n), _rand((n,), 1)
    b_j = jnp.asarray(b) if with_bias else None
    b_t = torch.from_numpy(b) if with_bias else None
    jplan = jengine.program(jnp.asarray(w), _jcfg("analog", wb, ab))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jengine.matmul(jnp.asarray(x), jplan, bias=b_j))
        for jname, name in (("analog", "analog"),
                            ("analog-pallas", "analog-cuda")):
            plan = engine.program(torch.from_numpy(w), _tcfg(name, wb, ab))
            conv = convert.plan_from_reference(
                jengine.program(jnp.asarray(w), _jcfg(jname, wb, ab)),
                device="cpu")
            assert plan.substrate == conv.substrate == name
            for p in (plan, conv):
                np.testing.assert_array_equal(
                    engine.matmul(torch.from_numpy(x), p, bias=b_t).numpy(),
                    want)


def test_depthwise_plans_stay_exact_on_analog_substrates():
    cols, w = _rand((6, 9, 12), 0), _rand((9, 12), 1)
    want = np.asarray(jengine.matmul(
        jnp.asarray(cols), jengine.program(jnp.asarray(w), _jcfg("analog"),
                                           kind="depthwise")))
    for name in ("analog", "analog-cuda"):
        plan = engine.program(torch.from_numpy(w), _tcfg(name),
                              kind="depthwise")
        np.testing.assert_array_equal(
            engine.matmul(torch.from_numpy(cols), plan).numpy(), want)


def test_noise_rules():
    x = torch.from_numpy(_rand((8, 64), 0))
    w = torch.from_numpy(_rand((64, 16), 1))
    for name in ("analog", "analog-cuda"):
        plan = engine.program(w, _tcfg(name, read_noise_sigma=0.05))
        with pytest.raises(ValueError, match="requires an rng"):
            engine.matmul(x, plan)
        y = [engine.matmul(x, plan, rng=torch.Generator().manual_seed(s))
             for s in (5, 5, 6)]
        assert torch.equal(y[0], y[1]) and not torch.equal(y[0], y[2])
        det = engine.matmul(x, plan, cfg=dataclasses.replace(
            plan.cfg, read_noise_sigma=0.0))
        assert not torch.equal(y[0], det)
    # the two routes evaluate the same normals for the same generator
    plans = [engine.program(w, _tcfg(s, read_noise_sigma=0.05))
             for s in ("analog", "analog-cuda")]
    outs = [engine.matmul(x, p, rng=torch.Generator().manual_seed(7))
            for p in plans]
    assert torch.equal(outs[0], outs[1])


def test_implied_sigma_applies_with_an_rng():
    x = torch.from_numpy(_rand((16, 128), 2))
    plan = engine.program(torch.from_numpy(_rand((128, 24), 3)),
                          _tcfg("analog"))
    assert pim._IMPLIED_READ_NOISE_SIGMA == \
        cell.DEFAULT_CELL.level_noise_sigma() > 0
    noisy = engine.matmul(x, plan, rng=torch.Generator().manual_seed(0))
    assert not torch.equal(noisy, engine.matmul(x, plan))


def test_noise_statistics_match_jax_analog():
    """Deviation from the deterministic readout over 8 seeds: mean near 0,
    standard deviation within 15% of JAX's over 8 keys."""
    sigma, seeds = 0.05, 8
    x, w = _rand((32, 192), 0), _rand((192, 32), 1)
    det = np.asarray(jengine.matmul(jnp.asarray(x), jengine.program(
        jnp.asarray(w), _jcfg("analog"))))
    jplan = jengine.program(jnp.asarray(w),
                            _jcfg("analog", read_noise_sigma=sigma))
    dev_j = np.stack([np.asarray(jengine.matmul(
        jnp.asarray(x), jplan, rng=jax.random.PRNGKey(s)))
        for s in range(seeds)]) - det
    plan = engine.program(torch.from_numpy(w),
                          _tcfg("analog", read_noise_sigma=sigma))
    dev_t = np.stack([engine.matmul(
        torch.from_numpy(x), plan,
        rng=torch.Generator().manual_seed(s)).numpy()
        for s in range(seeds)]) - det
    std_j, std_t = dev_j.std(), dev_t.std()
    assert abs(std_t - std_j) < 0.15 * max(std_t, std_j)
    assert abs(dev_t.mean()) < 0.1 * std_t


def _py_normal(seed, pair, c, r, k):
    """The counter-based normal with Python ints and numpy float32, one
    rounding per operation, as the CUDA kernel computes it."""
    m32 = 0xFFFFFFFF

    def rotl(x, s):
        return ((x << s) | (x >> (32 - s))) & m32

    def mix(h, v):
        v = rotl((v * 0xCC9E2D51) & m32, 15) * 0x1B873593 & m32
        return (rotl(h ^ v, 13) * 5 + 0xE6546B64) & m32

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & m32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & m32
        return h ^ (h >> 16)

    h = mix(mix(mix(mix(seed, pair), c), r), k)
    step = np.float32(2.0 ** -24)
    u1 = np.float32((fmix(mix(h, 1)) >> 8) + 1) * step
    u2 = np.float32(fmix(mix(h, 2)) >> 8) * step
    return u1, u2


def test_counter_normals_match_scalar_hash():
    """The vectorized generator (int64 tensors holding uint32) equals the
    hash written with Python ints, so no product overflowed; its values
    are standard normal."""
    z = ref.chunk_normals(0xDEADBEEF, 3, 5, 4, 6, 7, "cpu")
    assert z.shape == (4, 6, 7) and z.dtype == torch.float32
    for c, r, k in ((0, 0, 0), (3, 5, 6), (1, 2, 3)):
        u1, u2 = _py_normal(0xDEADBEEF, 3, 5 + c, r, k)
        want = torch.sqrt(torch.log(torch.tensor(u1)) * -2.0) * torch.cos(
            torch.tensor(u2) * torch.tensor(2 * np.pi, dtype=torch.float32))
        assert float(z[c, r, k]) == float(want)
    big = ref.chunk_normals(11, 0, 0, 64, 64, 64, "cpu")
    assert abs(float(big.mean())) < 0.01
    assert abs(float(big.std()) - 1.0) < 0.01
    assert not torch.equal(big, ref.chunk_normals(12, 0, 0, 64, 64, 64,
                                                  "cpu"))


def test_registry_config_conversion_and_aliases():
    assert engine.get_substrate("analog-pallas").name == "analog-cuda"
    for name in ("analog", "analog-cuda"):
        sub = engine.get_substrate(name)
        assert not sub.is_exact and sub.integer_datapath
    assert convert.config_from_reference(
        _jcfg("analog-pallas", adc_bits=6)).resolved_substrate == \
        "analog-cuda"
    legacy = convert.config_from_reference(
        {**dataclasses.asdict(jpim.PimConfig()), "substrate": None,
         "analog": True})
    assert legacy.resolved_substrate == "analog"


def test_cell_model_matches_jax():
    """Float32 surrogate physics: relative 1e-6 (XLA's and PyTorch's
    complex sqrt and pow may differ in the last bit)."""
    assert abs(cell.DEFAULT_CELL.level_noise_sigma()
               - jcell.DEFAULT_CELL.level_noise_sigma()) <= \
        1e-6 * jcell.DEFAULT_CELL.level_noise_sigma()
    widths = np.linspace(0.3, 0.7, 9).astype(np.float32)
    thick = np.linspace(5.0, 40.0, 8).astype(np.float32)
    for got, want in zip(cell.design_space(widths, thick),
                         jcell.design_space(jnp.asarray(widths),
                                            jnp.asarray(thick))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert cell.best_design(widths, thick) == pytest.approx(
        jcell.best_design(jnp.asarray(widths), jnp.asarray(thick)),
        rel=1e-6)
    np.testing.assert_allclose(cell.DEFAULT_CELL.levels().numpy(),
                               np.asarray(jcell.DEFAULT_CELL.levels()),
                               rtol=1e-6, atol=1e-7)
    assert float(cell.DEFAULT_CELL.contrast()) == pytest.approx(
        float(jcell.DEFAULT_CELL.contrast()), rel=1e-6)
