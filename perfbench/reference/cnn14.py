"""The plain fp32 Cnn14 of the benchmark's reference: the PANNs Cnn14 effect
classifier as the RemFX reference builds it (remfx/classifier.py:134-284 of
https://github.com/mhrice/RemFX), in eval mode.

A power mel spectrogram (torchaudio's ``MelSpectrogram``: Hann window,
centred with reflection, power 2, HTK mel scale, no filter norm) ->
per-example standardisation (ddof 1, the deviation floored at 1e-6) -> six
blocks of [3x3 conv, batch norm, ReLU] x 2 and 2x2 average pooling (the
window clamped to the input; none after the sixth) -> the mean over time,
then max + mean over mel -> fc1 and ReLU -> one sigmoid head per effect.
State-dict names: ``conv_block{n}.conv1``, ``bn1``, ``fc1``, ``heads.{i}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: float) -> np.ndarray:
    """(n_mels, n_freqs) triangular HTK filters from 0 Hz to sample_rate / 2,
    unnormalised (torchaudio's ``melscale_fbanks`` defaults), float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).T


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x, pool: bool):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if pool:
            size = (min(2, x.shape[2]), min(2, x.shape[3]))
            x = F.avg_pool2d(x, size, stride=size)
        return x


class Cnn14(nn.Module):
    def __init__(self, num_classes=5, sample_rate=48000, n_fft=2048, hop_length=512,
                 n_mels=128, widths=(64, 128, 256, 512, 1024, 2048)):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        n = np.arange(n_fft)
        self.register_buffer("window", torch.tensor(
            0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft)), dtype=torch.float32),
            persistent=False)
        self.register_buffer("fb", torch.tensor(
            mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate), dtype=torch.float32),
            persistent=False)
        for i, (cin, cout) in enumerate(zip((1,) + tuple(widths[:-1]), widths)):
            self.add_module(f"conv_block{i + 1}", ConvBlock(cin, cout))
        self.fc1 = nn.Linear(widths[-1], widths[-1])
        self.heads = nn.ModuleList(nn.Linear(widths[-1], 1) for _ in range(num_classes))

    def forward(self, x):
        """(B, 1, T) -> (B, num_classes) probabilities."""
        return torch.sigmoid(self.logits(x))

    def logits(self, x):
        """(B, 1, T) -> (B, num_classes), the heads' outputs before the sigmoid."""
        z = torch.stft(x[:, 0], self.n_fft, self.hop_length, window=self.window,
                       center=True, pad_mode="reflect", return_complex=True)
        m = torch.matmul(self.fb, z.real ** 2 + z.imag ** 2)  # (B, mel, frames)
        mean = m.mean(dim=(1, 2), keepdim=True)
        std = torch.sqrt(((m - mean) ** 2).sum(dim=(1, 2), keepdim=True)
                         / (m.shape[1] * m.shape[2] - 1))
        h = ((m - mean) / torch.clamp(std, min=1e-6))[:, None]
        for i in range(1, 7):
            h = getattr(self, f"conv_block{i}")(h, pool=i < 6)
        h = h.mean(dim=3)
        h = h.max(dim=2).values + h.mean(dim=2)
        h = F.relu(self.fc1(h))
        return torch.cat([head(h) for head in self.heads], dim=-1)
