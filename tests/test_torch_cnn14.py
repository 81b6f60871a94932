"""Cnn14 of the port against the JAX package, at the classifier's fixed
widths (64..2048) and the shipped front end (n_fft 2048, hop 512, 128
mels), with weights carried from a JAX init through ``from_jax``.

Tolerance: probabilities to 1e-4 absolute (fp32 through 12 convs and
two dense layers, summed in another order), thresholded labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu_torch.compat.from_jax import cnn14_state_dict
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.cnn14 import ConvBlock

torch.set_num_threads(2)
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    net = jax_make_cnn14()
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((2, 16384)))
    variables = jax.device_get(variables)
    # trained-like batch stats, so BatchNorm's running statistics matter
    rng = np.random.default_rng(7)
    stats = jax.tree.map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) * 0.5 + 0.5).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    port = make_cnn14(device="cpu")
    port.load_state_dict(cnn14_state_dict(variables), strict=True)
    return net, variables, port


def _clips(T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1, T)).astype(np.float32)
    x[1] *= np.linspace(0.0, 1.0, T, dtype=np.float32)  # unlike clip 0
    return 0.3 * x


# 16384 samples -> 33 frames; 4096 -> 9 frames: the time axis reaches 1
# after the third pool, so the clamp (cnn14.py:41-42) sets the window of
# blocks 4 and 5 to (2, 1)
@pytest.mark.parametrize("T", [16384, 4096])
def test_probs_and_labels_match_jax(pair, T):
    net, variables, port = pair
    x = _clips(T)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


def test_pool_window_is_clamped_to_the_input():
    block = ConvBlock(1, 4).eval()
    x = torch.randn(1, 1, 4, 1)  # width 1: a 2x2 pool would give size 0
    with torch.no_grad():
        y = block(x, (2, 2))
    assert y.shape == (1, 4, 2, 1)
    with torch.no_grad():
        assert block(torch.randn(1, 1, 1, 1), (2, 2)).shape == (1, 4, 1, 1)


def test_other_sample_rate_is_refused():
    """Another input rate was refused before the port had a resampler; it
    is now resampled to the model's rate (ops/resample.py), as the JAX
    Cnn14 does: 44.1 kHz in, the same probabilities as JAX (TOL)."""
    net = jax_make_cnn14(sample_rate=44100, model_sample_rate=48000)
    x = _clips(15000, seed=3)
    variables = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(1),
                                                 jnp.asarray(x)))
    port = make_cnn14(sample_rate=44100, model_sample_rate=48000, device="cpu")
    port.load_state_dict(cnn14_state_dict(variables), strict=True)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL
