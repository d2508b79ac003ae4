"""CNN parity on the remaining Table-II topologies: SqueezeNet (fire
modules, conv head), InceptionV2 (four-branch blocks with a 3x3 average
pool, which sums in another order than XLA's reduce_window) and VGG16 at
32x32 (stage pooling, and the dense head's spatial-mean fallback). The
check, its eager-only JAX reference and its tolerance are those of
``test_torch_cnn.py``: the average pool's order can differ by ulps, and a
flipped code would show as a whole quantization step."""
from test_torch_cnn import assert_matches_jax


def test_squeezenet_matches_jax_eager():
    assert_matches_jax("squeezenet", 32, 0.25)


def test_inceptionv2_matches_jax_eager():
    assert_matches_jax("inceptionv2", 16, 0.25)


def test_vgg16_matches_jax_eager():
    assert_matches_jax("vgg16", 32, 0.125)
