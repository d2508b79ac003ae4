"""The hand-written SSD scan kernel (``csrc/ssd_scan.cu``) against its
plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU
and nvcc and skips without them; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_ssd.py

Tolerance: rtol 2e-4, atol 2e-5 (the JAX package's bound between its
kernel and its sequential oracle): the kernel's products are 3xTF32 on the
tensor cores, float32 sums in another order than the plain versions'
(the yardstick ``ssd_scan_serial``, float32 FMAs on the CUDA cores, is
held to the same bound). TF32 stays off for the plain versions' matmuls
(``allow_tf32`` is set False in the fixture). Two launches on the same
inputs must agree bit for bit: no atomics, a fixed order of every sum.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (LAUNCHES, ssd_scan_cuda,
                                                   yardstick_serial)
from repro_torch.models import lm

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-4, atol=2e-5)
# (BH, L, P, N, chunk): hymba-1.5b and mamba2-370m at batch 8, prompt
# 512; a ragged tail; odd and small dimensions; a chunk above 128; the
# yardstick's column counts per lane (P up to 32, 64, 128) and the chunk
# pass's second column pass (P above 64)
SHAPES = ((400, 512, 64, 16, 128), (256, 512, 64, 128, 128),
          (16, 600, 64, 16, 128), (3, 97, 5, 3, 20), (2, 33, 1, 1, 7),
          (4, 512, 64, 16, 256), (1, 8, 8, 8, 8), (3, 200, 128, 32, 64),
          (2, 70, 40, 7, 33), (2, 300, 100, 5, 96))
# 16 chunks (L = 2048) at mamba2's and hymba's widths, and a ragged 17th
MANY_CHUNKS = ((16, 2048, 64, 128, 128), (32, 2048, 64, 16, 128),
               (8, 2100, 64, 128, 128))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(bh, l, p, n, device, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, l, p))
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((bh, l)) + 2.0))) \
        if decay is None else np.full((bh, l), decay)
    b = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    c = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    return [torch.from_numpy(v.astype(np.float32)).to(device)
            for v in (x, a, b, c)]


def assert_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("bh,l,p,n,q", SHAPES)
def test_kernel_matches_plain(cuda, bh, l, p, n, q):
    args = inputs(bh, l, p, n, cuda, seed=l + n)
    got = ssd_scan_cuda(*args, q)
    torch.cuda.synchronize()
    assert_close(got, ssd_scan_ref(*args))
    if l % q == 0:
        assert_close(got, ssd_chunked_ref(*args, chunk=q))


@pytest.mark.parametrize("bh,l,p,n,q", MANY_CHUNKS)
def test_kernel_matches_plain_over_many_chunks(cuda, bh, l, p, n, q):
    args = inputs(bh, l, p, n, cuda, seed=l + n + 1)
    got = ssd_scan_cuda(*args, q)
    torch.cuda.synchronize()
    assert_close(got, ssd_scan_ref(*args))
    if l % q == 0:
        assert_close(got, ssd_chunked_ref(*args, chunk=q))


@pytest.mark.parametrize("bh,l,p,n,q", ((256, 512, 64, 128, 128),
                                         (400, 600, 64, 16, 128),
                                         (3, 97, 5, 3, 20)))
def test_two_launches_agree_bit_for_bit(cuda, bh, l, p, n, q):
    args = inputs(bh, l, p, n, cuda, seed=3)
    first = ssd_scan_cuda(*args, q)
    second = ssd_scan_cuda(*args, q)
    for f, s in zip(first, second):
        assert torch.equal(f, s)


@pytest.mark.parametrize("bh,l,p,n,q", ((256, 512, 64, 128, 128),
                                         (16, 600, 64, 16, 128),
                                         (2, 300, 100, 5, 96)))
def test_serial_yardstick_matches_plain(cuda, bh, l, p, n, q):
    args = inputs(bh, l, p, n, cuda, seed=4)
    before = LAUNCHES["ssd_scan"]
    got = yardstick_serial(*args, q)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == before
    assert_close(got, ssd_scan_ref(*args))


def test_long_decay_finite(cuda):
    args = inputs(8, 256, 64, 16, cuda, seed=1, decay=1e-6)
    y, s = ssd_scan_cuda(*args, 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert_close((y, s), ssd_scan_ref(*args))


def test_ops_launches_on_cuda_even_when_ragged(cuda):
    args = inputs(4, 100, 16, 8, cuda, seed=2)
    before = LAUNCHES["ssd_scan"]
    for backend in ("cuda", "pallas", "pallas_interp"):
        got = ops.ssd_scan(*args, chunk=32, backend=backend)
        assert_close(got, ssd_scan_ref(*args))
    assert LAUNCHES["ssd_scan"] == before + 3
    ops.ssd_scan(*args, chunk=32, backend="chunked")
    assert LAUNCHES["ssd_scan"] == before + 3


def test_wrapper_rejects_bad_inputs(cuda):
    x, a, b, c = inputs(2, 16, 8, 4, cuda)
    with pytest.raises(ValueError):
        ssd_scan_cuda(x.double(), a, b, c, 8)
    with pytest.raises(ValueError):
        ssd_scan_cuda(x, a, b, c, 0)
    with pytest.raises(ValueError):
        ssd_scan_cuda(x.cpu(), a, b, c, 8)
    with pytest.raises(ValueError, match="P <= 128"):
        ssd_scan_cuda(*inputs(1, 16, 129, 4, cuda), 8)
    # a block that needs more shared memory than the card has
    x, a, b, c = inputs(1, 512, 128, 256, cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        ssd_scan_cuda(x, a, b, c, 512)
    # and the next launch is clean
    assert_close(ssd_scan_cuda(*inputs(2, 16, 8, 4, cuda), 8),
                 ssd_scan_ref(*inputs(2, 16, 8, 4, cuda)))


def test_reduced_hymba_prefill_through_the_kernel(cuda):
    cfg = dataclasses.replace(
        get_config("hymba-1.5b").reduced(num_layers=2, d_model=64,
                                         vocab=128), ssd_backend="cuda")
    params = lm.init_lm(cfg, 0, device=cuda)
    toks = torch.randint(0, 128, (2, 40), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    before = LAUNCHES["ssd_scan"]
    got, _ = lm.prefill(params, cfg, {"tokens": toks}, max_len=48)
    assert LAUNCHES["ssd_scan"] == before + cfg.num_layers
    want, _ = lm.prefill(params, dataclasses.replace(
        cfg, ssd_backend="sequential"), {"tokens": toks}, max_len=48)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
