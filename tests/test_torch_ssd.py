"""SSD scan parity: the port's plain versions (``ssd_scan_ref``,
``ssd_chunked_ref``) and its public entry point ``ops.ssd_scan`` with
``backend="cuda"`` (on CPU tensors: the kernel's plain version) against
the JAX package's ``ssd_scan_ref``, ``ssd_chunked_ref`` and
``ssd_scan_pallas`` run in interpret mode, on the same numpy inputs.

Tolerance: rtol 2e-4, atol 2e-5, the JAX package's own bound between its
kernel and its sequential oracle (``tests/test_kernels.py``): the chunked
form reassociates the float32 sums of the recurrence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan.ref import ssd_chunked_ref as j_chunked
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_seq
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import LAUNCHES

TOL = dict(rtol=2e-4, atol=2e-5)
# (BH, L, P, N, chunk): the shapes of tests/test_kernels.py
SHAPES = ((2, 128, 16, 8, 32), (1, 64, 8, 128, 64), (3, 96, 32, 16, 32),
          (1, 32, 64, 64, 32))


def _inputs(bh, l, p, n, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, l, p)).astype(np.float32)
    if decay is None:
        a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((bh, l)) + 2.0)))
    else:
        a = np.full((bh, l), decay)
    b = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    c = rng.standard_normal((bh, l, n)) / np.sqrt(n)
    return [v.astype(np.float32) for v in (x, a, b, c)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bh,l,p,n,q", SHAPES)
def test_plain_versions_match_jax(bh, l, p, n, q):
    arrs = _inputs(bh, l, p, n, seed=bh * l)
    ta = [torch.from_numpy(v) for v in arrs]
    ja = [jnp.asarray(v) for v in arrs]
    _close(ssd_scan_ref(*ta), j_seq(*ja))
    _close(ssd_chunked_ref(*ta, chunk=q), j_chunked(*ja, chunk=q))
    # and the chunked form against the sequential oracle
    _close(ssd_chunked_ref(*ta, chunk=q), j_seq(*ja))


@pytest.mark.parametrize("bh,l,p,n,q", SHAPES)
def test_cuda_backend_on_cpu_matches_pallas_interpret(bh, l, p, n, q):
    arrs = _inputs(bh, l, p, n, seed=bh * l + 1)
    before = LAUNCHES["ssd_scan"]
    for backend in ("cuda", "pallas", "pallas_interp"):
        got = ops.ssd_scan(*[torch.from_numpy(v) for v in arrs], chunk=q,
                           backend=backend)
        want = ssd_scan_pallas(*[jnp.asarray(v) for v in arrs], chunk=q,
                               interpret=True)
        _close(got, want)
    # CPU tensors never launch the kernel
    assert LAUNCHES["ssd_scan"] == before


def test_long_decay_stays_finite():
    """a = 1e-6 (near-total forgetting): exp(cl_i - cl_j) above the
    diagonal overflows to inf and must be selected away, not masked by a
    multiply."""
    arrs = _inputs(1, 64, 8, 8, seed=1, decay=1e-6)
    y, s = ops.ssd_scan(*[torch.from_numpy(v) for v in arrs], chunk=32,
                        backend="cuda")
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close((y, s), ssd_scan_pallas(*[jnp.asarray(v) for v in arrs],
                                   chunk=32, interpret=True))
    _close((y, s), j_seq(*[jnp.asarray(v) for v in arrs]))


@pytest.mark.parametrize("backend", ["cuda", "chunked", "sequential"])
def test_ragged_length_matches_jax(backend):
    """L % chunk != 0: the plain routes go sequential, as JAX's ops do."""
    arrs = _inputs(2, 100, 16, 8, seed=5)
    got = ops.ssd_scan(*[torch.from_numpy(v) for v in arrs], chunk=32,
                       backend=backend)
    jb = {"cuda": "pallas_interp"}.get(backend, backend)
    _close(got, jops.ssd_scan(*[jnp.asarray(v) for v in arrs], chunk=32,
                              backend=jb))


def test_chunk_clamped_to_length():
    arrs = _inputs(2, 24, 8, 4, seed=6)
    got = ops.ssd_scan(*[torch.from_numpy(v) for v in arrs], chunk=128,
                       backend="cuda")
    _close(got, jops.ssd_scan(*[jnp.asarray(v) for v in arrs], chunk=128,
                              backend="chunked"))


def test_initial_state():
    arrs = _inputs(2, 40, 8, 4, seed=7)
    s0 = np.random.default_rng(8).standard_normal((2, 4, 8)).astype(
        np.float32)
    got = ssd_scan_ref(*[torch.from_numpy(v) for v in arrs],
                       s0=torch.from_numpy(s0))
    _close(got, j_seq(*[jnp.asarray(v) for v in arrs], s0=jnp.asarray(s0)))


def test_unknown_backend_raises():
    arrs = [torch.from_numpy(v) for v in _inputs(1, 8, 4, 4)]
    with pytest.raises(ValueError, match="ssd_backend"):
        ops.ssd_scan(*arrs, chunk=4, backend="triton")
    with pytest.raises(ValueError, match="multiple"):
        ssd_chunked_ref(*arrs, chunk=3)
