"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU and nvcc and
skips without them; this file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core.pim import PimConfig
from repro_torch.core.workloads import mobilenet, resnet18
from repro_torch.kernels.pim_matmul import ops
from repro_torch.kernels.pim_matmul.pim_matmul import (LAUNCHES,
                                                       ROUTE_LAUNCHES,
                                                       pim_matmul_cuda,
                                                       pim_matmul_fused_cuda,
                                                       small_m_grid,
                                                       yardstick_fused)
from repro_torch.kernels.pim_matmul.ref import (pim_matmul_fused_ref,
                                                pim_matmul_ref)
from repro_torch.models.cnn import cnn_forward, init_cnn, plan_cnn_weights

pytestmark = pytest.mark.cuda

# (M, K, N): ragged in every dimension, one tile, several K steps, and
# the fc shape of the CNN path
SHAPES = ((1, 1, 1), (37, 333, 77), (128, 64, 64), (300, 1024, 130),
          (128, 512, 100))
PLANES = ((1, 1), (1, 2), (2, 1), (2, 2))
# the small-M route (M <= 64): hymba-1.5b's four decode shapes (q/o, k/v,
# gate/up, down) at M from 1 to 64, and split and strip boundaries: K not
# a whole number of K splits, N not a whole number of strips
HYMBA_DECODE_KN = ((2048, 1664), (2048, 384), (2048, 5504), (5632, 1664))
SMALL_M_SHAPES = tuple((m, k, n) for m in (1, 2, 7, 8, 9, 16, 31, 33, 64)
                       for k, n in HYMBA_DECODE_KN) + (
    (5, 333, 77), (8, 1000, 250), (64, 129, 33), (12, 3000, 100),
    (3, 127, 40))

# the wgmma route (M > 64, K and N multiples of 16): hymba-1.5b's prefill
# projections (batch 8 x prompt 512), ResNet18's convolutions at batch 128
# (K as the plans pad it), and ragged M and N (partial tiles of 128 or 256
# rows and of 64 or 128 columns) with K short of a stage or one 16 past it;
# the last two take 256-row tiles at w4a4
HYMBA_PREFILL = tuple((4096, k, n) for k, n in HYMBA_DECODE_KN)
RESNET18_SHAPES = ((131072, 32, 64), (131072, 1024, 64), (32768, 64, 128),
                   (32768, 1024, 128), (32768, 1536, 128), (8192, 128, 256),
                   (8192, 1536, 256), (8192, 2560, 256), (2048, 256, 512),
                   (2048, 2560, 512), (2048, 4608, 512))
WGMMA_RAGGED = ((65, 16, 16), (200, 144, 80), (129, 1040, 208),
                (1000, 336, 48), (130, 2048, 1664), (300, 1024, 144),
                (4100, 1040, 2064), (34000, 144, 64))
WGMMA_SHAPES = HYMBA_PREFILL + RESNET18_SHAPES + WGMMA_RAGGED


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(pa, pw, m, k, n, device, seed=0, lo=-15, hi=16):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi, size=(pa, m, k)).astype(np.int8)
    w = rng.integers(lo, hi, size=(pw, k, n)).astype(np.int8)
    a_s = (rng.random((m, 1)) + 0.1).astype(np.float32)
    w_s = (rng.random((1, n)) + 0.1).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, w, a_s, w_s, bias)]


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_variants_bit_exact(cuda, pa, pw, m, k, n):
    a, w, a_s, w_s, bias = _inputs(pa, pw, m, k, n, cuda)
    assert torch.equal(pim_matmul_cuda(a, w), pim_matmul_ref(a, w))
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s),
                       pim_matmul_fused_ref(a, w, a_s, w_s))
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s, bias),
                       pim_matmul_fused_ref(a, w, a_s, w_s, bias))
    out, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, bias, want_rowsum=True)
    ref_out, ref_rs = pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                           want_rowsum=True)
    assert torch.equal(out, ref_out) and torch.equal(rs, ref_rs)


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", SMALL_M_SHAPES)
def test_small_m_route_bit_exact(cuda, pa, pw, m, k, n):
    """Every variant on the small-M route, full-range int8 planes."""
    assert small_m_grid(m, k, n)[0] == "small_m"
    a, w, a_s, w_s, bias = _inputs(pa, pw, m, k, n, cuda, seed=m + k + n,
                                   lo=-128, hi=128)
    assert torch.equal(pim_matmul_cuda(a, w), pim_matmul_ref(a, w))
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s),
                       pim_matmul_fused_ref(a, w, a_s, w_s))
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s, bias),
                       pim_matmul_fused_ref(a, w, a_s, w_s, bias))
    out, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, bias, want_rowsum=True)
    ref_out, ref_rs = pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                           want_rowsum=True)
    assert torch.equal(out, ref_out) and torch.equal(rs, ref_rs)


def test_small_m_route_wraps_mod_2_32(cuda):
    """The wrap case at decode's M = 8: every accumulator and every K
    split's partial overflows int32; the route wraps like the plain
    version, row-sums included."""
    m, k, n = 8, 5632, 1664
    assert small_m_grid(m, k, n)[2] > 1
    a, w, a_s, w_s, bias = _inputs(2, 2, m, k, n, cuda, seed=4, lo=100,
                                   hi=128)
    codes = [(p[0].double() + 16 * p[1].double()) for p in (a, w)]
    assert bool(((codes[0] @ codes[1]).abs() > 2 ** 31).all())
    assert torch.equal(pim_matmul_cuda(a, w), pim_matmul_ref(a, w))
    out, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, bias, want_rowsum=True)
    ref_out, ref_rs = pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                           want_rowsum=True)
    assert torch.equal(out, ref_out) and torch.equal(rs, ref_rs)


def test_kernel_wraps_mod_2_32(cuda):
    """Large same-signed int8 planes (fault injection can write any int8)
    overflow int32 at w8a8: the kernel wraps like the int32 reference."""
    a, w, a_s, w_s, _ = _inputs(2, 2, 64, 4096, 64, cuda, seed=3,
                                lo=100, hi=128)
    ref = pim_matmul_ref(a, w)
    codes = [(p[0].double() + 16 * p[1].double()) for p in (a, w)]
    exact = codes[0] @ codes[1]              # integers < 2^53: exact
    assert bool((exact.abs() > 2 ** 31).all())
    assert torch.equal(pim_matmul_cuda(a, w), ref)
    _, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, want_rowsum=True)
    assert torch.equal(rs, pim_matmul_fused_ref(a, w, a_s, w_s,
                                                want_rowsum=True)[1])


def test_ops_dispatch_by_device_and_count(cuda):
    a, w, a_s, w_s, bias = _inputs(1, 1, 40, 96, 24, cuda)
    before = dict(LAUNCHES)
    on_card = ops.pim_matmul_fused(a, w, a_s, w_s, bias)
    ops.pim_matmul_int(a, w)
    assert LAUNCHES["pim_matmul_fused"] == before["pim_matmul_fused"] + 1
    assert LAUNCHES["pim_matmul_int"] == before["pim_matmul_int"] + 1
    on_cpu = ops.pim_matmul_fused(a.cpu(), w.cpu(), a_s.cpu(), w_s.cpu(),
                                  bias.cpu())
    assert LAUNCHES["pim_matmul_fused"] == before["pim_matmul_fused"] + 1
    assert torch.equal(on_card.cpu(), on_cpu)


def test_wrapper_rejects_bad_inputs(cuda):
    a, w, a_s, w_s, _ = _inputs(1, 1, 16, 32, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pim_matmul_cuda(a.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="contraction"):
        pim_matmul_cuda(a, w[:, :16])
    with pytest.raises(ValueError, match="a_scale"):
        pim_matmul_fused_cuda(a, w, a_s.double(), w_s)
    with pytest.raises(ValueError, match="one device"):
        ops.pim_matmul_int(a, w.cpu())


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("builder", (
    lambda: resnet18(8, 16, width=0.25), lambda: mobilenet(8, 16, width=0.25)))
def test_cnn_exact_cuda_equals_exact_torch(cuda, builder, bits):
    layers = builder()
    params = init_cnn(layers, torch.Generator().manual_seed(0), device=cuda)
    cfg = PimConfig(weight_bits=bits, act_bits=bits, substrate="exact-cuda")
    plans = plan_cnn_weights(params, layers, cfg)
    x = torch.randn((4, 16, 16, 3), generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    out = cnn_forward(params, layers, x, pim=cfg, plans=plans)
    ref = cnn_forward(params, layers, x, plans=plans,
                      pim=PimConfig(weight_bits=bits, act_bits=bits,
                                    substrate="exact-torch"))
    assert out.shape == (4, 8) and torch.isfinite(out).all()
    assert torch.equal(out, ref)


def test_engine_bias_fused_bit_exact(cuda):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((33, 200), generator=g).to(cuda)
    w = torch.randn((200, 72), generator=g).to(cuda)
    b = torch.randn((72,), generator=g).to(cuda)
    plan = engine.program(w, PimConfig(substrate="exact-cuda"))
    ref = engine.matmul(x, plan, bias=b,
                        cfg=PimConfig(substrate="exact-torch"))
    assert torch.equal(engine.matmul(x, plan, bias=b), ref)


def _card_inputs(pa, pw, m, k, n, device, seed, lo=-128, hi=128):
    """_inputs drawn on the card (the large shapes' planes are hundreds of
    MB)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(lo, hi, (pa, m, k), generator=gen, device=device,
                      dtype=torch.int8)
    w = torch.randint(lo, hi, (pw, k, n), generator=gen, device=device,
                      dtype=torch.int8)
    a_s = torch.rand((m, 1), generator=gen, device=device) + 0.1
    w_s = torch.rand((1, n), generator=gen, device=device) + 0.1
    bias = torch.randn((1, n), generator=gen, device=device)
    return a, w, a_s, w_s, bias


def _all_variants_equal(a, w, a_s, w_s, bias):
    assert torch.equal(pim_matmul_cuda(a, w), pim_matmul_ref(a, w))
    want = pim_matmul_fused_ref(a, w, a_s, w_s)
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s), want)
    want_b, want_rs = pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                           want_rowsum=True)
    assert torch.equal(pim_matmul_fused_cuda(a, w, a_s, w_s, bias), want_b)
    out, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, bias, want_rowsum=True)
    assert torch.equal(out, want_b) and torch.equal(rs, want_rs)
    _, rs = pim_matmul_fused_cuda(a, w, a_s, w_s, want_rowsum=True)
    assert torch.equal(rs, want_rs)
    return want_b, want_rs


@pytest.mark.parametrize("pa,pw", PLANES)
@pytest.mark.parametrize("m,k,n", WGMMA_SHAPES)
def test_wgmma_route_bit_exact(cuda, pa, pw, m, k, n):
    """Every variant on the wgmma route, full-range int8 planes, against
    the plain version and the mma.sync kernel it replaced."""
    assert small_m_grid(m, k, n) == ("wgmma", 0, 0)
    a, w, a_s, w_s, bias = _card_inputs(pa, pw, m, k, n, cuda, m + k + n)
    before = dict(ROUTE_LAUNCHES["pim_matmul_fused"])
    want, want_rs = _all_variants_equal(a, w, a_s, w_s, bias)
    assert ROUTE_LAUNCHES["pim_matmul_fused"]["wgmma"] == \
        before["wgmma"] + 4
    for symbol in ("pim_matmul_fused_tiled", "pim_matmul_fused_mma_sync"):
        out, rs = yardstick_fused(symbol, a, w, a_s, w_s, bias,
                                  want_rowsum=True)
        assert torch.equal(out, want) and torch.equal(rs, want_rs)


@pytest.mark.parametrize("m,k,n", HYMBA_PREFILL + ((300, 1024, 144),))
def test_wgmma_kmajor_yardstick_bit_exact(cuda, m, k, n):
    """The wgmma route on K-major weight planes (nothing to transpose)
    gives the same bits."""
    a, w, a_s, w_s, bias = _card_inputs(1, 1, m, k, n, cuda, k + n)
    w_k = w.transpose(1, 2).contiguous()
    out, rs = yardstick_fused("pim_matmul_fused_kmajor", a, w_k, a_s, w_s,
                              bias, want_rowsum=True)
    want, want_rs = pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                         want_rowsum=True)
    assert torch.equal(out, want) and torch.equal(rs, want_rs)


def test_wgmma_route_wraps_mod_2_32(cuda):
    """The wrap case on the wgmma route: same-signed planes in [100, 128)
    at w8a8 take every accumulator beyond 2^31; the route wraps like the
    plain version, row-sums included."""
    m, k, n = 256, 5632, 1664
    assert small_m_grid(m, k, n)[0] == "wgmma"
    a, w, a_s, w_s, bias = _card_inputs(2, 2, m, k, n, cuda, 5, lo=100,
                                        hi=128)
    codes = [(p[0].double() + 16 * p[1].double()) for p in (a, w)]
    assert bool(((codes[0] @ codes[1]).abs() > 2 ** 31).all())
    _all_variants_equal(a, w, a_s, w_s, bias)


@pytest.mark.parametrize("pa,pw", ((1, 1), (2, 2)))
def test_wgmma_level_overflow_wraps(cuda, pa, pw):
    """Every plane 127 and K = 139,264: each shift level's own sum
    (127 * 127 * K per plane pair) overflows int32 inside the tensor
    cores' s32 accumulation; without .satfinite it wraps, so the result
    equals the plain version."""
    m, k, n = 128, 139264, 64
    assert small_m_grid(m, k, n)[0] == "wgmma"
    assert 127 * 127 * k > 2 ** 31
    a = torch.full((pa, m, k), 127, dtype=torch.int8, device=cuda)
    w = torch.full((pw, k, n), 127, dtype=torch.int8, device=cuda)
    _, _, a_s, w_s, bias = _card_inputs(1, 1, m, 16, n, cuda, 6)
    _all_variants_equal(a, w, a_s, w_s, bias)
