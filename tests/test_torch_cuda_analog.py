"""The port's analog-readout CUDA kernels (``csrc/analog_readout.cu``)
against their plain PyTorch versions, on the card. Every test here needs
an NVIDIA GPU and nvcc and skips without them; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_analog.py

On the deterministic path (no noise) both passes equal the plain version
bit for bit, on both routes (``analog_route``: the tensor-core route at
chunks 4, 8 and 16, the CUDA-core route otherwise and with noise), with
the activation planes as wide as the weight planes or narrower (Ka < Kw),
and the yardstick symbols (the CUDA-core kernel at any chunk) equal the
route. The tensor-core route's ADC equals the IEEE divide and its
rounding for every integer chunk sum in [-2^22, 2^22]. With noise, the
kernel and the plain version evaluate the same counter-based normals;
only the transcendental functions of the normal transform (logf, cosf)
may round differently from PyTorch's, so a noisy check allows a few
outputs to move by whole ADC codes (see ``_assert_noisy_close``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import engine
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import resnet18
from repro_torch.kernels.analog_readout import ops
from repro_torch.kernels.analog_readout.analog_readout import (
    LAUNCHES, ROUTE_LAUNCHES, adc_check_cuda, analog_fullscale_cuda,
    analog_readout_cuda, analog_route, reset_launches, yardstick_fullscale,
    yardstick_readout)
from repro_torch.kernels.analog_readout.ref import (analog_fullscale_ref,
                                                    analog_readout_ref,
                                                    inv_half_levels,
                                                    lsb_from_fullscale)
from repro_torch.models.cnn import cnn_forward, init_cnn, plan_cnn_weights

pytestmark = pytest.mark.cuda

# (M, K, N): ragged in every dimension, one tile, several K steps
SHAPES = ((1, 8, 1), (37, 336, 77), (64, 64, 64), (300, 1024, 130),
          (128, 512, 100))
PLANES = ((1, 1), (1, 2), (2, 1), (2, 2))
# (chunk, adc_bits): the three unrolled chunks and two generic ones, and a
# 24-bit ADC, whose small lsb sends the tensor-core route's blocks down
# their divide path
SWEEP = ((4, 3), (8, 5), (16, 8), (3, 5), (24, 6), (8, 24))
# a noisy check may move at most this share of outputs (normals whose
# last-ulp transcendental rounding lands a chunk sum across a code edge)
NOISY_SHARE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(pa, pw, m, k, n, device, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, size=(pa, m, k)).astype(np.int8)
    w = rng.integers(-15, 16, size=(pw, k, n)).astype(np.int8)
    a_s = (rng.random((m, 1)) + 0.1).astype(np.float32)
    w_s = (rng.random((1, n)) + 0.1).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, w, a_s, w_s, bias)]


def _pad_w(w, chunk):
    """Weight planes padded to a whole number of chunks, as plans are."""
    return F.pad(w, (0, 0, 0, (-w.shape[1]) % chunk))


def _narrow(a, ka):
    """The activation planes cut to their first ``ka`` K columns."""
    return a[:, :, :ka].contiguous()


def _both_passes(a, w, a_s, w_s, bias, chunk, adc, sigma=0.0, seed=None):
    kw = dict(chunk=chunk, sigma=sigma, seed=seed)
    fs = analog_fullscale_cuda(a, w, **kw)
    ref_fs = analog_fullscale_ref(a, w, chunk, sigma, seed).reshape(1)
    out = analog_readout_cuda(a, w, a_s, w_s, ref_fs, adc_bits=adc,
                              bias=bias, **kw)
    ref = analog_readout_ref(a, w, a_s, w_s, ref_fs, chunk, adc, sigma,
                             seed, bias)
    return fs, ref_fs, out, ref


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_passes_bit_exact(cuda, pa, pw, m, k, n):
    a, w, a_s, w_s, bias = _inputs(pa, pw, m, k, n, cuda)
    for b in (None, bias):
        fs, ref_fs, out, ref = _both_passes(a, w, a_s, w_s, b, 8, 5)
        assert torch.equal(fs, ref_fs)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("chunk,adc", SWEEP)
def test_chunk_and_adc_sweep_bit_exact(cuda, chunk, adc):
    k = 12 * chunk + chunk * (chunk % 5)        # several K steps, ragged
    a, w, a_s, w_s, bias = _inputs(2, 2, 77, k, 45, cuda, seed=chunk)
    fs, ref_fs, out, ref = _both_passes(a, w, a_s, w_s, bias, chunk, adc)
    assert torch.equal(fs, ref_fs) and torch.equal(out, ref)


@pytest.mark.parametrize("chunk,adc", SWEEP)
@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_routes_and_yardsticks_bit_exact(cuda, m, k, n, pa, pw, chunk,
                                         adc):
    """Every shape, plane count, chunk and ADC width: both passes on their
    route against the plain versions, with the activations as wide as the
    (chunk-padded) weights and cut to Ka < Kw (Ka not a chunk multiple
    where K allows); the yardstick symbols equal to the route; a second
    launch bit for bit."""
    a, w, a_s, w_s, bias = _inputs(pa, pw, m, k, n, cuda, seed=k + chunk)
    w = _pad_w(w, chunk)
    for ka in sorted({k, max(1, k - chunk - 3), max(1, k // 3)}):
        a_k = _narrow(a, ka)
        a_pad = F.pad(a_k, (0, w.shape[1] - ka))
        reset_launches()
        fs = analog_fullscale_cuda(a_k, w, chunk=chunk)
        want_fs = analog_fullscale_ref(a_pad, w, chunk).reshape(1)
        assert torch.equal(fs, want_fs)
        assert torch.equal(yardstick_fullscale(a_k, w, chunk=chunk), fs)
        for b in (None, bias):
            kw = dict(chunk=chunk, adc_bits=adc, bias=b)
            out = analog_readout_cuda(a_k, w, a_s, w_s, fs, **kw)
            assert torch.equal(out, analog_readout_ref(
                a_pad, w, a_s, w_s, want_fs, chunk, adc, bias=b))
            assert torch.equal(
                yardstick_readout(a_k, w, a_s, w_s, fs, **kw), out)
            assert torch.equal(
                analog_readout_cuda(a_k, w, a_s, w_s, fs, **kw), out)
        route = analog_route(chunk, False)
        assert ROUTE_LAUNCHES["analog_fullscale"] == {
            r: int(r == route) for r in ROUTE_LAUNCHES["analog_fullscale"]}
        assert ROUTE_LAUNCHES["analog_readout"][route] == 4
        assert LAUNCHES["analog_readout"] == 4


def test_launches_by_route(cuda):
    """Deterministic calls at chunks 4, 8, 16 take the tensor-core route,
    chunk 3 and noisy calls the CUDA-core route; the yardsticks and the
    ADC check count nothing."""
    a, w, a_s, w_s, _ = _inputs(1, 1, 70, 48, 40, cuda)
    reset_launches()
    for chunk, sigma, seed in ((4, 0.0, None), (8, 0.0, None),
                               (16, 0.0, None), (3, 0.0, None),
                               (8, 0.05, 7), (8, 0.05, None)):
        fs = analog_fullscale_cuda(a, w, chunk=chunk, sigma=sigma, seed=seed)
        analog_readout_cuda(a, w, a_s, w_s, fs, chunk=chunk, adc_bits=5,
                            sigma=sigma, seed=seed)
    yardstick_fullscale(a, w, chunk=8)
    adc_check_cuda(0.5, -10, 10)
    want = {"mma_sync": 4, "simt": 2}
    assert ROUTE_LAUNCHES == {"analog_fullscale": want,
                              "analog_readout": want}
    assert LAUNCHES == {"analog_fullscale": 6, "analog_readout": 6}


@pytest.mark.parametrize("adc_bits", (2, 5, 8, 24))
def test_adc_matches_divide_on_every_integer(cuda, adc_bits):
    """The tensor-core route's ADC (the quotient from a reciprocal and two
    FMA corrections, then magic-number rounding) against __fdiv_rn(s, lsb)
    and __float2int_rn of it for every integer s in [-2^22, 2^22], at full
    scales a chunk sum can give and at the floor."""
    inv = np.float32(inv_half_levels(adc_bits))
    for fs in (1e-6, 1.0, 7.0, 225.0, 1000.0, 1800.0, 3600.0, 262144.0):
        lsb = float(np.float32(fs) * inv)
        bad, _ = adc_check_cuda(lsb, -(1 << 22), 1 << 22)
        assert bad == 0, (fs, bad)


def test_fullscale_word_is_fresh_per_call(cuda):
    """A large drive then a small one: a full-scale word carried over from
    the first call would range the second with the wrong max."""
    a, w, *_ = _inputs(1, 1, 64, 64, 32, cuda)
    big = analog_fullscale_cuda(a, w, chunk=8)
    small_a = torch.clamp(a, -1, 1)
    small = analog_fullscale_cuda(small_a, w, chunk=8)
    assert torch.equal(big, analog_fullscale_ref(a, w, 8).reshape(1))
    assert torch.equal(small, analog_fullscale_ref(small_a, w, 8).reshape(1))
    assert bool(small < big)


def test_zero_drive_uses_the_floor(cuda):
    a, w, a_s, w_s, _ = _inputs(1, 1, 16, 32, 8, cuda)
    a = torch.zeros_like(a)
    fs = analog_fullscale_cuda(a, w, chunk=8)
    assert float(fs) == 0.0
    out = analog_readout_cuda(a, w, a_s, w_s, fs, chunk=8, adc_bits=5)
    assert torch.equal(out, torch.zeros_like(out))
    assert float(lsb_from_fullscale(fs, 5)) > 0.0


def _assert_noisy_close(out, ref, a_s, w_s, lsb, levels):
    """Outputs equal except where a normal's last ulp moved a chunk sum
    across a code edge: each such output moves by whole codes of its
    shift level, and only a few outputs may."""
    diff = (out.double() - ref.double()).abs()
    step = (lsb.double() * a_s.double() * w_s.double())
    codes = diff / step
    moved = diff > 0
    assert float(moved.double().mean()) <= NOISY_SHARE
    if bool(moved.any()):
        assert float(codes[moved].max()) <= 2 * 16 ** (levels - 1) + 1e-3


@pytest.mark.parametrize("pa,pw", ((1, 1), (2, 2)))
def test_noise_matches_plain_and_is_reproducible(cuda, pa, pw):
    a, w, a_s, w_s, _ = _inputs(pa, pw, 200, 336, 77, cuda, seed=5)
    fs, ref_fs, out, ref = _both_passes(a, w, a_s, w_s, None, 8, 5,
                                        sigma=0.05, seed=1234)
    assert float((fs - ref_fs).abs() / ref_fs) <= 1e-6
    _assert_noisy_close(out, ref, a_s, w_s, lsb_from_fullscale(ref_fs, 5),
                        pa + pw - 1)
    kw = dict(chunk=8, adc_bits=5)
    again = analog_readout_cuda(a, w, a_s, w_s, ref_fs, sigma=0.05,
                                seed=1234, **kw)
    other = analog_readout_cuda(a, w, a_s, w_s, ref_fs, sigma=0.05,
                                seed=1235, **kw)
    det = analog_readout_cuda(a, w, a_s, w_s, ref_fs, **kw)
    assert torch.equal(out, again)
    assert not torch.equal(out, other) and not torch.equal(out, det)


def test_ops_dispatch_pads_k_and_counts(cuda):
    a, w, a_s, w_s, bias = _inputs(2, 1, 40, 37, 24, cuda)
    before = dict(LAUNCHES)
    on_card = ops.analog_matmul_fused(a, w, a_s, w_s, None, bias, chunk=8,
                                      adc_bits=5)
    assert LAUNCHES["analog_fullscale"] == before["analog_fullscale"] + 1
    assert LAUNCHES["analog_readout"] == before["analog_readout"] + 1
    on_cpu = ops.analog_matmul_fused(a.cpu(), w.cpu(), a_s.cpu(), w_s.cpu(),
                                     None, bias.cpu(), chunk=8, adc_bits=5)
    assert LAUNCHES["analog_readout"] == before["analog_readout"] + 1
    assert torch.equal(on_card.cpu(), on_cpu)


def test_wrapper_rejects_bad_inputs(cuda):
    a, w, a_s, w_s, _ = _inputs(1, 1, 16, 32, 8, cuda)
    with pytest.raises(ValueError, match="multiple of the WDM chunk"):
        analog_fullscale_cuda(a[:, :, :30].contiguous(),
                              w[:, :30].contiguous(), chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        analog_fullscale_cuda(a.transpose(1, 2).contiguous().transpose(1, 2),
                              w, chunk=8)
    fs = analog_fullscale_cuda(a, w, chunk=8)
    with pytest.raises(ValueError, match="fullscale"):
        analog_readout_cuda(a, w, a_s, w_s, fs.reshape(()), chunk=8,
                            adc_bits=5)
    with pytest.raises(ValueError, match="one device"):
        ops.analog_matmul_fused(a, w.cpu(), a_s, w_s, chunk=8, adc_bits=5)
    with pytest.raises(ValueError, match="exceeds the weight planes"):
        analog_fullscale_cuda(a, w[:, :24].contiguous(), chunk=8)


@pytest.mark.parametrize("bits", (4, 8))
def test_cnn_analog_cuda_equals_analog(cuda, bits):
    layers = resnet18(8, 16, width=0.25)
    params = init_cnn(layers, torch.Generator().manual_seed(0), device=cuda)
    cfg = PimConfig(weight_bits=bits, act_bits=bits, substrate="analog-cuda")
    plans = plan_cnn_weights(params, layers, cfg)
    x = torch.randn((4, 16, 16, 3), generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    plain = PimConfig(weight_bits=bits, act_bits=bits, substrate="analog")
    out = cnn_forward(params, layers, x, pim=cfg, plans=plans)
    ref = cnn_forward(params, layers, x, pim=plain, plans=plans)
    assert out.shape == (4, 8) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref)
    noisy = [cnn_forward(params, layers, x, pim=cfg, plans=plans,
                         rng=torch.Generator().manual_seed(s))
             for s in (9, 9, 10)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    assert not torch.equal(noisy[0], out)


def test_engine_bias_fused_equals_plain(cuda):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((33, 200), generator=g).to(cuda)
    w = torch.randn((200, 72), generator=g).to(cuda)
    b = torch.randn((72,), generator=g).to(cuda)
    plan = engine.program(w, PimConfig(substrate="analog-cuda"))
    ref = engine.matmul(x, plan, bias=b, cfg=PimConfig(substrate="analog"))
    assert torch.equal(engine.matmul(x, plan, bias=b), ref)
