"""CNN parity on the analog readout route: the port's ``cnn_forward`` on
``analog`` and ``analog-cuda`` (parameters and plans converted from the
JAX package) against the JAX package's eager ``analog`` forward on a
reduced ResNet18, and the noise contract of the executor.

The JAX side runs eagerly (see ``test_torch_cnn.py``). Tolerance: that
of ``test_torch_cnn.py`` — every layer's readout is bit-exact (integer
ADC codes, one IEEE divide, single-rounding epilogue), so only the
spatial means may sum in another order; a flipped activation code or ADC
code would move a logit by a whole step, far above it.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workloads as jworkloads
from repro.core.pim import PimConfig as JaxPimConfig
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import workloads
from repro_torch.core.pim import PimConfig
from repro_torch.data.pipeline import synthetic_images
from repro_torch.models import cnn
from test_torch_cnn import ATOL, CLASSES, RTOL

HW, WIDTH, BATCH = 16, 0.25, 4


@pytest.fixture(scope="module")
def resnet():
    """Reduced ResNet18: JAX parameters and plans, their conversions, the
    images, and JAX's eager deterministic analog logits (computed once:
    the eager per-op compilation is this file's cost)."""
    jlayers = jworkloads.resnet18(CLASSES, HW, width=WIDTH)
    params = jcnn.init_cnn(jlayers, jax.random.PRNGKey(0))
    jcfg = JaxPimConfig(weight_bits=4, act_bits=4, adc_bits=5,
                        substrate="analog")
    jplans = jcnn.plan_cnn_weights(params, jlayers, jcfg)
    x, _ = synthetic_images(0, BATCH, HW, CLASSES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.array(jcnn.cnn_forward(params, jlayers, jnp.asarray(x),
                                        pim=jcfg, plans=jplans))
    return dict(layers=workloads.resnet18(CLASSES, HW, width=WIDTH),
                params=convert.params_from_reference(params, device="cpu"),
                jplans=jplans, x=torch.from_numpy(x), ref=ref)


@pytest.mark.parametrize("substrate", ("analog", "analog-cuda"))
def test_resnet18_analog_matches_jax_eager(resnet, substrate):
    cfg = PimConfig(weight_bits=4, act_bits=4, adc_bits=5,
                    substrate=substrate)
    plans = cnn.plan_cnn_weights(resnet["params"], resnet["layers"], cfg)
    converted = convert.plans_from_reference(resnet["jplans"], device="cpu")
    outs = [cnn.cnn_forward(resnet["params"], resnet["layers"], resnet["x"],
                            pim=cfg, plans=p) for p in (plans, converted)]
    assert torch.equal(outs[0], outs[1])
    got = outs[0].numpy()
    assert got.shape == (BATCH, CLASSES)
    np.testing.assert_array_equal(got.argmax(1), resnet["ref"].argmax(1))
    np.testing.assert_allclose(got, resnet["ref"], rtol=RTOL, atol=ATOL)


def test_noisy_forward_is_keyed_by_the_generator(resnet):
    """The same generator seed gives bit-identical logits on a rerun and
    on either analog route; another seed, or none, gives others."""
    run = lambda sub, rng: cnn.cnn_forward(
        resnet["params"], resnet["layers"], resnet["x"],
        pim=PimConfig(weight_bits=4, act_bits=4, adc_bits=5, substrate=sub),
        rng=rng)
    seeded = lambda s: torch.Generator().manual_seed(s)
    first = run("analog-cuda", seeded(9))
    assert bool(torch.isfinite(first).all())
    assert torch.equal(first, run("analog-cuda", seeded(9)))
    assert torch.equal(first, run("analog", seeded(9)))
    assert not torch.equal(first, run("analog-cuda", seeded(10)))
    assert not torch.equal(first, torch.from_numpy(resnet["ref"]))
