"""The paper's comparison platforms and the legacy PIM wrappers in the
port (``repro_torch.core.baselines``; ``pim_matmul``,
``pim_depthwise_matmul`` and ``pim_linear`` of ``repro_torch.core.pim``)
against the JAX package's.

Tolerances:
- every number of ``comparison_table``, ``average_ratios``,
  ``PHPIM_MODEL``, ``phpim_epb_j_per_bit`` and the platform constants:
  equal bit for bit (the same float64 arithmetic on the same constants);
- the paper-claim checks of ``tests/test_paper_claims.py``: the same
  bounds, on the port;
- the legacy wrappers on ``exact-torch`` against ``exact-jnp``, and the
  analog substrate at ``rng=None``: bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import pim as jpim
from repro.quant.quantize import quantize as jquantize
from repro_torch import core as tcore
from repro_torch.core import baselines as tb
from repro_torch.core import pim
from repro_torch.quant.quantize import quantize as tquantize

BITS = ((4, 4), (8, 8))


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wb,ab", BITS + ((4, 8),))
def test_comparison_table_bit_exact(wb, ab):
    want = jb.comparison_table(wb, ab)
    got = tb.comparison_table(wb, ab)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert tb.average_ratios(wb, ab) == jb.average_ratios(wb, ab)


def test_platform_constants_bit_exact():
    names = ("P100", "E7742", "ORIN", "PRIME", "CROSSLIGHT", "PHPIM")
    for name in names:
        assert dataclasses.asdict(getattr(tb, name)) == \
            dataclasses.asdict(getattr(jb, name)), name
    assert [p.name for p in tb.ALL_PLATFORMS] == \
        [p.name for p in jb.ALL_PLATFORMS]
    assert [p.name for p in tb.ELECTRONIC] == [p.name for p in jb.ELECTRONIC]
    assert dataclasses.asdict(tb.PHPIM_MODEL) == \
        dataclasses.asdict(jb.PHPIM_MODEL)
    assert tb.PAPER_RATIOS == jb.PAPER_RATIOS
    assert tb.OPIMA_EPB_J_PER_BIT == jb.OPIMA_EPB_J_PER_BIT
    for frac in (0.0, 0.0397, 0.5, 1.0):
        assert tb.phpim_epb_j_per_bit(frac) == jb.phpim_epb_j_per_bit(frac)


def test_phpim_model_bit_exact():
    from repro.core.workloads import WORKLOADS as JW
    from repro_torch.core.workloads import WORKLOADS as TW
    for name in JW:
        jl, tl = JW[name](), TW[name]()
        for wb, ab in BITS:
            assert tb.PHPIM_MODEL.latency_s(name, tl, wb, ab) == \
                jb.PHPIM_MODEL.latency_s(name, jl, wb, ab)
            assert tb.PHPIM_MODEL.fps_per_watt(name, tl, wb, ab) == \
                jb.PHPIM_MODEL.fps_per_watt(name, jl, wb, ab)
        for p, q in zip(tb.ALL_PLATFORMS, jb.ALL_PLATFORMS):
            assert p.latency_s(tl) == q.latency_s(jl)
            assert p.fps_per_watt(tl, 4) == q.fps_per_watt(jl, 4)


def test_platform_ratios_match_paper():
    """``tests/test_paper_claims.py``'s ratio checks, on the port: each
    average ratio within 15% of the paper's."""
    r = tb.average_ratios()
    for plat, targets in tb.PAPER_RATIOS.items():
        got = r[plat]
        assert abs(got["epb"] - targets["epb"]) / targets["epb"] < 0.15, \
            (plat, got["epb"], targets["epb"])
        assert abs(got["fps_per_watt"] - targets["fps_per_watt"]) / \
            targets["fps_per_watt"] < 0.15, (plat, got["fps_per_watt"])


def test_headline_throughput_vs_best_prior():
    """§I: 2.98x the throughput of the best prior work (PhPIM)."""
    assert abs(tb.average_ratios()["PhPIM"]["throughput"] - 2.98) < 0.30


def test_core_exports_match_the_reference():
    """``repro_torch.core`` exports what ``repro.core`` exports."""
    import repro.core as jcore
    names = [n for n in vars(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    assert [n for n in names if not hasattr(tcore, n)] == []


# ---------------------------------------------------------------------------
# the legacy wrappers
# ---------------------------------------------------------------------------
def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cfgs(wb, ab, jsub="exact-jnp", tsub="exact-torch"):
    return (jpim.PimConfig(weight_bits=wb, act_bits=ab, substrate=jsub),
            pim.PimConfig(weight_bits=wb, act_bits=ab, substrate=tsub))


@pytest.mark.parametrize("with_bias", (False, True))
@pytest.mark.parametrize("wb,ab", BITS)
def test_pim_matmul_and_linear_bit_exact(wb, ab, with_bias):
    x, w, b = _rand((2, 9, 96), 0), _rand((96, 40), 1), _rand((40,), 2)
    jcfg, tcfg = _cfgs(wb, ab)
    jbias = jnp.asarray(b) if with_bias else None
    tbias = torch.from_numpy(b) if with_bias else None
    want = jpim.pim_matmul(jnp.asarray(x), jpim.prepare_weights(
        jnp.asarray(w), jcfg), bias=jbias)
    got = pim.pim_matmul(torch.from_numpy(x), pim.prepare_weights(
        torch.from_numpy(w), tcfg), bias=tbias)
    assert tuple(got.shape) == (2, 9, 40)
    np.testing.assert_array_equal(_np(got), _np(want))
    want = jpim.pim_linear(jnp.asarray(x), jnp.asarray(w), jbias, jcfg)
    got = pim.pim_linear(torch.from_numpy(x), torch.from_numpy(w), tbias,
                         tcfg)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("wb,ab", BITS)
def test_pim_matmul_qtensor_adopts_weight_bits(wb, ab):
    """A legacy QTensor is planned on the fly; with no cfg the default
    config adopts the codes' width (8-bit codes under the 4-bit default),
    and an explicit cfg of the codes' width gives the same bits."""
    x, w = _rand((7, 64), 3), _rand((64, 24), 4)
    jq = jquantize(jnp.asarray(w), bits=wb, axis=(0,))
    tq = tquantize(torch.from_numpy(w), bits=wb, axis=(0,))
    np.testing.assert_array_equal(_np(tq.values), _np(jq.values))
    want = jpim.pim_matmul(jnp.asarray(x), jq)
    got = pim.pim_matmul(torch.from_numpy(x), tq)
    np.testing.assert_array_equal(_np(got), _np(want))
    jcfg, tcfg = _cfgs(wb, ab)
    np.testing.assert_array_equal(
        _np(pim.pim_matmul(torch.from_numpy(x), tq, tcfg)),
        _np(jpim.pim_matmul(jnp.asarray(x), jq, jcfg)))


def test_pim_matmul_explicit_mismatch_raises_in_both():
    """An explicit cfg whose width disagrees with the plan's trips the
    engine's guard in both packages."""
    w = _rand((32, 16), 5)
    jcfg8, tcfg8 = _cfgs(8, 8)
    jcfg4, tcfg4 = _cfgs(4, 4)
    jplan = jpim.prepare_weights(jnp.asarray(w), jcfg8)
    tplan = pim.prepare_weights(torch.from_numpy(w), tcfg8)
    with pytest.raises(ValueError, match="weight_bits"):
        jpim.pim_matmul(jnp.ones((2, 32), jnp.float32), jplan, jcfg4)
    with pytest.raises(ValueError, match="weight_bits"):
        pim.pim_matmul(torch.ones((2, 32)), tplan, tcfg4)


@pytest.mark.parametrize("wb,ab", BITS)
def test_pim_depthwise_matmul_bit_exact(wb, ab):
    cols, w = _rand((3, 5, 9, 12), 6), _rand((9, 12), 7)
    jcfg, tcfg = _cfgs(wb, ab)
    want = jpim.pim_depthwise_matmul(jnp.asarray(cols), jnp.asarray(w), jcfg)
    got = pim.pim_depthwise_matmul(torch.from_numpy(cols),
                                   torch.from_numpy(w), tcfg)
    assert tuple(got.shape) == (3, 5, 12)
    np.testing.assert_array_equal(_np(got), _np(want))
    # a plan, with the plan's own cfg
    want = jpim.pim_depthwise_matmul(jnp.asarray(cols),
                                     jpim.prepare_depthwise_weights(
                                         jnp.asarray(w), jcfg))
    got = pim.pim_depthwise_matmul(torch.from_numpy(cols),
                                   pim.prepare_depthwise_weights(
                                       torch.from_numpy(w), tcfg))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("with_bias", (False, True))
@pytest.mark.parametrize("tsub", ("analog", "analog-cuda"))
def test_pim_linear_analog_bit_exact(tsub, with_bias):
    """The analog routes at ``rng=None`` (the ADC's deterministic readout)
    through the legacy wrapper equal JAX's ``analog`` bit for bit; on CPU
    tensors ``analog-cuda`` runs its plain version."""
    x, w, b = _rand((6, 64), 8), _rand((64, 24), 9), _rand((24,), 10)
    jcfg, tcfg = _cfgs(4, 4, "analog", tsub)
    jcfg = dataclasses.replace(jcfg, adc_bits=6, read_noise_sigma=0.0)
    tcfg = dataclasses.replace(tcfg, adc_bits=6, read_noise_sigma=0.0)
    want = jpim.pim_linear(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(b) if with_bias else None, jcfg)
    got = pim.pim_linear(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b) if with_bias else None, tcfg)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_pim_matmul_analog_rng_reaches_the_substrate():
    """``rng`` reaches the analog substrate: with noise on, the same seed
    repeats the output and another seed changes it, and without an rng
    an explicit sigma raises, as ``engine.matmul`` does."""
    x, w = torch.from_numpy(_rand((6, 64), 11)), \
        torch.from_numpy(_rand((64, 24), 12))
    cfg = pim.PimConfig(substrate="analog", read_noise_sigma=0.05)
    plan = pim.prepare_weights(w, cfg)
    a = pim.pim_matmul(x, plan, rng=torch.Generator().manual_seed(3))
    b = pim.pim_matmul(x, plan, rng=torch.Generator().manual_seed(3))
    c = pim.pim_matmul(x, plan, rng=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="requires an rng"):
        pim.pim_matmul(x, plan)
