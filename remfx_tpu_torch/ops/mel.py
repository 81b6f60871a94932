"""Mel filterbanks + mel spectrogram (torchaudio-compatible).

Counterpart of ``remfx_tpu/ops/mel.py``: ``torchaudio.transforms.
MelSpectrogram`` with its defaults (power 2, htk mel scale, no filter
norm, f_min 0, f_max sr/2, hann window, center/reflect) and no log: the
Cnn14 classifier standardises the raw power mel itself.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from remfx_tpu_torch.ops.stft import hann_window, stft_ri


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def melscale_fbanks(
    n_freqs: int,
    n_mels: int,
    sample_rate: float,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank (n_freqs, n_mels), htk scale, no norm —
    identical math to torchaudio.functional.melscale_fbanks defaults."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


class MelSpectrogram(nn.Module):
    """(..., T) -> (..., n_mels, n_frames) mel spectrogram of |X|^2."""

    def __init__(
        self,
        sample_rate: float,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_mels: int = 128,
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        # constants, not parameters: kept out of the state dict
        self.register_buffer("window", hann_window(n_fft), persistent=False)
        fb = melscale_fbanks(n_fft // 2 + 1, n_mels, sample_rate)
        self.register_buffer("fb_t", torch.from_numpy(fb.T.copy()),
                             persistent=False)  # (n_mels, n_freqs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The power and the filterbank product in ``x``'s dtype: an fp32
        filterbank would promote the classifier after it (the JAX
        package casts ``fb`` to ``x.dtype``, ``remfx_tpu/ops/mel.py:72-81``)."""
        re, im = stft_ri(x, self.n_fft, self.hop_length, self.window)
        return torch.matmul(self.fb_t.to(x.dtype), re * re + im * im)  # power 2
