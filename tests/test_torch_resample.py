"""The port's resampler (``remfx_tpu_torch/ops/resample.py``) against the
JAX package's (``remfx_tpu/ops/resample.py``), both torchaudio's
``sinc_interp_hann`` at its defaults.

The polyphase kernels are built in float64 numpy on both sides and
rounded once, so they are equal bit for bit. The filtered signal: 1e-6 x
the input's peak (fp32 dot products of about 2 x 6 x 160 / 147 taps,
summed in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu_torch.ops import resample as tres

# remfx_tpu.ops exports the function under the module's name
jres = importlib.import_module("remfx_tpu.ops.resample")

torch.set_num_threads(2)
TOL = 1e-6


def _signal(rate, seconds=0.25, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal((channels, n))
    return x.astype(np.float32)


@pytest.mark.parametrize("orig,new", [(44100, 48000), (16000, 48000), (48000, 44100)])
def test_resample_matches_jax(orig, new):
    x = _signal(orig)
    want = np.asarray(jres.resample(jnp.asarray(x), orig, new))
    got = tres.resample(x, orig, new)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (2, int(np.ceil(x.shape[-1] * new / orig)))
    assert np.abs(got - want).max() <= TOL * np.abs(x).max()


@pytest.mark.parametrize("orig,new", [(44100, 48000), (16000, 48000)])
def test_kernels_equal_jax_bit_for_bit(orig, new):
    want, got = jres._kernel(orig, new, 6, 0.99), tres._kernel(orig, new, 6, 0.99)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_tensor_in_tensor_out_and_batch_dims():
    x = _signal(16000, channels=3)
    xt = torch.from_numpy(x).reshape(3, 1, -1)
    y = tres.resample(xt, 16000, 48000)
    assert isinstance(y, torch.Tensor) and y.shape == (3, 1, 3 * x.shape[-1])
    np.testing.assert_array_equal(y.reshape(3, -1).numpy(), tres.resample(x, 16000, 48000))
    assert tres.resample(xt, 48000, 48000) is xt
