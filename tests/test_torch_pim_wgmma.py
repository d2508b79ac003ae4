"""The PIM matmul's routes as the CPU sees them: the route chooser
(``small_m_grid``) at its boundaries and at the main paths' shapes, the
wrappers' alignment rule, and the ``exact-cuda`` plan path at shapes that
take the wgmma route on the card, bit for bit against the JAX package's
``exact-jnp`` route, with one copy of the planes in the JAX layout. CPU
tensors run the plain versions, so these hold the Python around the
kernels; the kernels themselves are held on the card by
``tests/test_torch_cuda_kernels.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import pim as jpim
from repro_torch import engine
from repro_torch.configs import get_config
from repro_torch.core import pim, workloads
from repro_torch.kernels.pim_matmul import pim_matmul as kern
from repro_torch.models import cnn
from repro_torch.quant.quantize import QTensor


@pytest.mark.parametrize("m,k,n,route", (
    (64, 2048, 1664, "small_m"),     # the small-M limit
    (65, 2048, 1664, "wgmma"),       # the first M above it
    (7, 333, 77, "small_m"),         # small M takes any K and N
    (65, 2056, 1664, "mma_sync"),    # K % 16 == 8: no TMA row stride
    (65, 2040, 1664, "mma_sync"),
    (65, 2048, 1672, "mma_sync"),    # N % 16 == 8
    (65, 2048, 1680, "wgmma"),       # N % 16 == 0
    (128, 8, 64, "mma_sync"),        # K below one 16-byte row
    (128, 16, 16, "wgmma"),
    (128, 65520, 64, "wgmma"),       # K up to 65,535
    (128, 65536, 64, "wgmma"),       # and above: integer wgmma wraps,
    (128, 139264, 64, "wgmma"),      # so no level sum needs a limit
    (4096, 5632, 1664, "wgmma")))
def test_route_chooser_boundaries(m, k, n, route):
    assert kern.small_m_grid(m, k, n)[0] == route
    if route != "small_m":
        assert kern.small_m_grid(m, k, n) == (route, 0, 0)
        assert kern.tiled_route(k, n) == route


def test_main_path_shapes_take_their_routes():
    """ResNet18 at batch 128: every convolution on the wgmma route, fc (N
    = 100) on the mma.sync route; hymba-1.5b's projections on the wgmma
    route in prefill (batch 8 x prompt 512) and the small-M route in
    decode (batch 8)."""
    layers = workloads.resnet18(100, 32)
    params = cnn.init_cnn(layers, torch.Generator().manual_seed(0),
                          device="cpu")
    plans = cnn.plan_cnn_weights(params, layers, pim.PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-cuda"))
    routes = {}
    for spec in layers:
        rows = 128 * (spec.out_h * spec.out_w if hasattr(spec, "out_h")
                      else 1)
        k, n = plans[spec.name].planes.shape[1:]
        routes[spec.name] = kern.small_m_grid(rows, k, n)[0]
    assert list(routes.values()).count("wgmma") == len(layers) - 1
    assert [name for name, r in routes.items() if r == "mma_sync"] == \
        [layers[-1].name]
    cfg = get_config("hymba-1.5b")
    d, q = cfg.d_model, cfg.num_heads * cfg.head_dim
    for k, n in ((d, q), (q, d), (d, cfg.num_kv_heads * cfg.head_dim),
                 (d, cfg.d_ff), (cfg.d_ff, d)):
        codes = QTensor(values=torch.zeros((k, n), dtype=torch.int8),
                        scale=torch.ones((1, n)), bits=4)
        kp, np_ = pim.plan_from_qtensor(codes).planes.shape[1:]
        assert kern.small_m_grid(8 * 512, kp, np_)[0] == "wgmma"
        assert kern.small_m_grid(8, kp, np_)[0] == "small_m"


def test_misaligned_planes_take_the_mma_sync_route():
    """TMA needs 16-byte aligned planes: a contiguous view that starts off
    a 16-byte boundary takes the mma.sync route, an aligned one the wgmma
    route; the choice is made before any launch."""
    m, k, n = 130, 64, 32
    a = torch.zeros((1, m, k), dtype=torch.int8)
    w = torch.zeros((1, k, n), dtype=torch.int8)
    assert a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert kern._route(a, w)[0] == "wgmma"
    shifted = torch.zeros(m * k + 1, dtype=torch.int8)[1:].view(1, m, k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert kern._route(shifted, w)[0] == "mma_sync"


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_bias", (False, True))
@pytest.mark.parametrize("wb,ab", ((4, 4), (8, 8)))
def test_exact_cuda_plan_at_wgmma_shapes_matches_jax(wb, ab, with_bias):
    """The exact-cuda plan path, unchanged on the CPU: at a shape the card
    runs on the wgmma route, the planes keep the JAX layout (Pw, Kp, Np),
    equal to JAX's own, as the plan's only copy of them, and the result
    equals JAX's exact-jnp route bit for bit."""
    x, w, b = _rand((130, 300), 3), _rand((300, 208), 4), _rand((208,), 5)
    jplan = jengine.program(jnp.asarray(w), jpim.PimConfig(
        weight_bits=wb, act_bits=ab, substrate="exact-jnp"))
    ref = jengine.matmul(jnp.asarray(x), jplan,
                         bias=jnp.asarray(b) if with_bias else None)
    plan = engine.program(torch.from_numpy(w), pim.PimConfig(
        weight_bits=wb, act_bits=ab, substrate="exact-cuda"))
    pw, kp, np_ = plan.planes.shape
    assert pw == wb // 4 and kp >= 300 and np_ >= 208
    assert kern.small_m_grid(130, kp, np_)[0] == "wgmma"
    np.testing.assert_array_equal(plan.planes.numpy(),
                                  np.asarray(jplan.planes))
    tensors = [f.name for f in dataclasses.fields(plan)
               if isinstance(getattr(plan, f.name), torch.Tensor)]
    assert tensors == ["values", "scale", "planes", "padded_scale"]
    got = engine.matmul(torch.from_numpy(x), plan,
                        bias=torch.from_numpy(b) if with_bias else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
