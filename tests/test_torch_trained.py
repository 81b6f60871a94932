"""The vendored trained checkpoints carried into the port on the CPU.

``remfx_tpu.train.checkpoint`` (JAX, orbax) reads ``ckpts/``; the
variables go through ``compat.from_jax`` into the port, and both
packages run the same demo audio.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from remfx_tpu.train.checkpoint import load_trained_classifier, load_trained_wrapper
from remfx_tpu_torch.compat.from_jax import cnn14_state_dict, demucs_state_dict
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.models import make_cnn14, make_demucs

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _demo(T):
    x, sr = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    assert sr == 48000
    y, _ = read_wav(ROOT / "demos" / "synth_distortion_reverb.wav")
    return np.stack([x[:, :T], y[:, :T]]).astype(np.float32)  # (2, 1, T)


def test_trained_classifier_carries_over():
    """ckpts/classifier_cnn14_r5 through from_jax: the same probabilities
    (1e-4, as in test_torch_cnn14.py) and labels as JAX on demo audio."""
    net, variables = load_trained_classifier(ROOT / "ckpts" / "classifier_cnn14_r5")
    x = _demo(32768)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    port = make_cnn14(device="cpu")
    port.load_state_dict(cnn14_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


def test_trained_demucs_carries_over():
    """ckpts/demucs_compressor_aug_r5 (identity_init, so a residual
    wrapper) at full width through from_jax: the same removal as JAX to
    1e-4 x the output RMS, as in test_torch_demucs.py."""
    effect, jw, variables = load_trained_wrapper(ROOT / "ckpts" / "demucs_compressor_aug_r5")
    assert effect == "compressor" and jw.residual
    x = _demo(16384)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    port = make_demucs(identity_init=True, device="cpu")
    port.module.load_state_dict(demucs_state_dict(variables), strict=True)
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))
