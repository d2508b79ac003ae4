"""CNN parity: the port's ``cnn_forward`` on parameters converted from the
JAX package against the JAX package's eager ``exact-jnp`` forward, on
reduced ResNet18 and MobileNet.

The JAX side always runs eagerly, never under ``jax.jit``: XLA's fused
graph rounds differently, which flips activation codes that then compound
over the layers. Eager JAX is the op-by-op IEEE reference.

Tolerance: every layer's matmul is bit-exact and the glue between layers
(relu, residual adds, im2col, max-pool) is exact elementwise work, so the
only float reductions that may sum in another order are the spatial means
(the final one, and the head's). Those differ by a few ulps; a flipped
activation code anywhere upstream would move a logit by a whole
quantization step, orders of magnitude above ``RTOL``/``ATOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import workloads as jworkloads
from repro.core.pim import PimConfig as JaxPimConfig
from repro.data.pipeline import synthetic_images as jax_synthetic_images
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import workloads
from repro_torch.core.pim import PimConfig
from repro_torch.data.pipeline import synthetic_images
from repro_torch.models import cnn
from repro_torch.quant.quantize import fake_quantize

RTOL = 1e-6
ATOL = 1e-6
CLASSES = 8


def assert_matches_jax(name, hw, width, rtol=RTOL, atol=ATOL, batch=4):
    """Programming, converted plans and logits of one topology."""
    jlayers = getattr(jworkloads, name)(CLASSES, hw, width=width)
    layers = getattr(workloads, name)(CLASSES, hw, width=width)
    assert [dataclasses.asdict(s) for s in layers] == \
        [dataclasses.asdict(s) for s in jlayers]
    params = jcnn.init_cnn(jlayers, jax.random.PRNGKey(0))
    x, _ = synthetic_images(0, batch, hw, CLASSES)
    jcfg = JaxPimConfig(weight_bits=4, act_bits=4, substrate="exact-jnp")
    jplans = jcnn.plan_cnn_weights(params, jlayers, jcfg)
    ref = np.asarray(jcnn.cnn_forward(params, jlayers, jnp.asarray(x),
                                      pim=jcfg, plans=jplans))

    tparams = convert.params_from_reference(params, device="cpu")
    cfg = PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    plans = cnn.plan_cnn_weights(tparams, layers, cfg)
    for layer, plan in plans.items():
        for field in ("values", "scale", "planes"):
            np.testing.assert_array_equal(
                getattr(plan, field).numpy(),
                np.asarray(getattr(jplans[layer], field)), err_msg=layer)
    xt = torch.from_numpy(x)
    got = cnn.cnn_forward(tparams, layers, xt, pim=cfg, plans=plans)
    converted = cnn.cnn_forward(tparams, layers, xt, pim=cfg,
                                plans=convert.plans_from_reference(
                                    jplans, device="cpu"))
    assert torch.equal(got, converted)
    assert tuple(got.shape) == (batch, CLASSES)
    np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol)


def test_resnet18_matches_jax_eager():
    assert_matches_jax("resnet18", 16, 0.25)


def test_mobilenet_matches_jax_eager():
    assert_matches_jax("mobilenet", 16, 0.25)


def test_synthetic_images_match_reference():
    for a, b in zip(synthetic_images(3, 5, 16, 10),
                    jax_synthetic_images(3, 5, 16, 10)):
        np.testing.assert_array_equal(a, b)


def test_float_and_fake_quant_forwards():
    """The executor's non-PIM routes: ``quant_bits`` is the float forward
    on per-output-channel fake-quantized weights, and 8 bits stays closer
    to the float logits than 4 bits."""
    layers = workloads.resnet18(CLASSES, 8, width=0.125)
    params = cnn.init_cnn(layers, torch.Generator().manual_seed(0),
                          device="cpu")
    x = torch.from_numpy(synthetic_images(1, 2, 8, CLASSES)[0])
    ref = cnn.cnn_forward(params, layers, x)
    err = {}
    for bits in (4, 8):
        fq = {name: {"w": fake_quantize(p["w"].reshape(-1, p["w"].shape[-1]),
                                        bits, axis=(0,)).reshape(
                                            p["w"].shape),
                     "b": p["b"]} for name, p in params.items()}
        got = cnn.cnn_forward(params, layers, x, quant_bits=bits)
        assert torch.equal(got, cnn.cnn_forward(fq, layers, x))
        err[bits] = float((got - ref).abs().max())
    assert ref.shape == (2, CLASSES) and 0 < err[8] < err[4]
