"""STFT / iSTFT / mel of the port against the JAX package.

Tolerance: 1e-5 relative to the reference's largest magnitude. The JAX
package computes the DFT as an fp32 matrix product at HIGHEST precision,
the port through an FFT; both are fp32 and differ in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.ops import mel as jmel
from remfx_tpu.ops.stft import hann_window as j_hann
from remfx_tpu.ops.stft import istft_ri as j_istft_ri
from remfx_tpu.ops.stft import stft_ri as j_stft_ri
from remfx_tpu_torch.ops import mel as tmel
from remfx_tpu_torch.ops import stft as tstft

torch.set_num_threads(2)
TOL = 1e-5
# HDemucs' framing (nfft 64 as in the small test config, and 4096), hop
# nfft/4; Cnn14's 2048/512
FRAMINGS = [(64, 16), (4096, 1024), (2048, 512)]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _signal(T, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((2, T))).astype(np.float32)


def test_hann_window_is_the_jax_window():
    for n in (64, 2048, 4096):
        np.testing.assert_array_equal(tstft.hann_window(n).numpy(),
                                      np.asarray(j_hann(n)))


@pytest.mark.parametrize("n_fft,hop", FRAMINGS)
def test_stft_ri_matches_jax(n_fft, hop):
    x = _signal(3 * n_fft + 37)
    jre, jim = j_stft_ri(jnp.asarray(x), n_fft, hop, j_hann(n_fft))
    tre, tim = tstft.stft_ri(torch.from_numpy(x), n_fft, hop, tstft.hann_window(n_fft))
    jre, jim = np.asarray(jre), np.asarray(jim)
    assert tre.shape == jre.shape and tim.shape == jim.shape
    scale = np.abs(np.concatenate([jre, jim])).max()
    assert np.abs(tre.numpy() - jre).max() / scale <= TOL
    assert np.abs(tim.numpy() - jim).max() / scale <= TOL


@pytest.mark.parametrize("n_fft,hop", FRAMINGS)
@pytest.mark.parametrize("extra", [0, -5, 7])
def test_istft_ri_matches_jax(n_fft, hop, extra):
    T = 3 * n_fft + 37
    x = _signal(T, seed=1)
    w = j_hann(n_fft)
    jre, jim = j_stft_ri(jnp.asarray(x), n_fft, hop, w)
    length = T + extra  # cut, exact, and zero-padded lengths
    want = np.asarray(j_istft_ri(jre, jim, n_fft, hop, w, length=length))
    got = tstft.istft_ri(torch.from_numpy(np.array(jre)),
                         torch.from_numpy(np.array(jim)), n_fft, hop,
                         tstft.hann_window(n_fft), length=length).numpy()
    assert got.shape == want.shape == (2, length)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (4096, 1024)])
def test_istft_ri_ignores_dc_and_nyquist_imag_as_jax_does(n_fft, hop):
    """A spectrum from a network is not Hermitian at DC and Nyquist; the
    JAX inverse DFT ignores those imaginary parts."""
    rng = np.random.default_rng(3)
    nf, frames = n_fft // 2 + 1, 12
    re = rng.standard_normal((2, nf, frames)).astype(np.float32)
    im = rng.standard_normal((2, nf, frames)).astype(np.float32)
    w = j_hann(n_fft)
    want = np.asarray(j_istft_ri(jnp.asarray(re), jnp.asarray(im), n_fft, hop, w))
    got = tstft.istft_ri(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                         tstft.hann_window(n_fft)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_melscale_fbanks_is_the_jax_filterbank():
    np.testing.assert_array_equal(tmel.melscale_fbanks(1025, 128, 48000),
                                  jmel.melscale_fbanks(1025, 128, 48000))


@pytest.mark.parametrize("n_fft,hop,n_mels", [(2048, 512, 128), (1024, 256, 64)])
def test_mel_spectrogram_matches_jax(n_fft, hop, n_mels):
    x = _signal(16384, seed=2)
    want = np.asarray(jmel.MelSpectrogram(48000, n_fft, hop, n_mels)(jnp.asarray(x)))
    got = tmel.MelSpectrogram(48000, n_fft, hop, n_mels)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
