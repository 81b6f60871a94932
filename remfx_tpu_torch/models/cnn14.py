"""Cnn14 (PANNs) multi-label effect classifier.

Counterpart of ``remfx_tpu/models/cnn14.py`` (reference
``remfx/classifier.py:134-284``): torchaudio-style power mel spectrogram
(n_fft 2048, hop 512, 128 mels for the shipped config) -> per-example
standardisation (ddof=1 std, floored at 1e-6) -> 6 ConvBlocks (64..2048,
each 2x[3x3 conv + BN + ReLU] + 2x2 avg pool, the window clamped to the
input) -> mean over time, then max + mean over mel -> fc 2048 -> 5
independent sigmoid heads.

Layout is NCHW, ``(B, 1, mel, time)``, where the JAX module is NHWC; the
state-dict names are the reference's (``conv_block{n}.conv1``, ``bn1``,
``fc1``, ``heads.{i}``). The reference's ``bn0`` is never applied in its
forward; the JAX module declares it without ever creating its
parameters, so it has no parameters here either. SpecAugment is a
training-time option and waits for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.ops.mel import MelSpectrogram


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x, pool_size=(2, 2)):
        """x: (B, C, H, W); 3x3 conv-BN-ReLU twice, then average pooling."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        # clamp the window to the input so short clips never pool a
        # spatial dim to zero size (cnn14.py:41-42 of the JAX package)
        pool_size = (min(pool_size[0], x.shape[2]), min(pool_size[1], x.shape[3]))
        if pool_size != (1, 1):
            x = F.avg_pool2d(x, pool_size, stride=pool_size)
        return x


class Cnn14(nn.Module):
    def __init__(
        self,
        num_classes: int,
        sample_rate: float,
        model_sample_rate: float,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_mels: int = 128,
    ):
        super().__init__()
        if sample_rate != model_sample_rate:
            # the JAX module resamples here (ops/resample.py); the port
            # has no resampler yet
            raise ValueError(
                f"sample_rate {sample_rate} != model_sample_rate "
                f"{model_sample_rate}: resampling is not ported yet"
            )
        self.melspec = MelSpectrogram(model_sample_rate, n_fft, hop_length, n_mels)
        widths = (64, 128, 256, 512, 1024, 2048)
        for i, (cin, cout) in enumerate(zip((1,) + widths[:-1], widths)):
            self.add_module(f"conv_block{i + 1}", ConvBlock(cin, cout))
        self.fc1 = nn.Linear(2048, 2048)
        self.heads = nn.ModuleList(nn.Linear(2048, 1) for _ in range(num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, T) or (B, T) -> (B, num_classes) sigmoid probs."""
        h = self.embed(x)
        return torch.cat([torch.sigmoid(head(h)) for head in self.heads], dim=-1)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The 2048-d post-fc1 ReLU features."""
        if x.dim() == 3:
            x = x[:, 0, :]
        m = self.melspec(x)  # (B, mel, time)
        # per-example standardisation over (mel, time), ddof=1 like torch.std
        mean = m.mean(dim=(1, 2), keepdim=True)
        n = m.shape[1] * m.shape[2]
        var = ((m - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
        # a silent clip has var 0; real spectrograms sit far above the floor
        m = (m - mean) / torch.clamp(torch.sqrt(var), min=1e-6)

        h = m[:, None]  # (B, 1, mel, time)
        for i in range(1, 6):
            h = getattr(self, f"conv_block{i}")(h, (2, 2))
            h = F.dropout(h, 0.2, self.training)
        h = F.dropout(self.conv_block6(h, (1, 1)), 0.2, self.training)
        # (B, C, mel', time'): reduce time (mean), then mel (max + mean)
        h = h.mean(dim=3)
        h = h.max(dim=2).values + h.mean(dim=2)
        h = F.dropout(h, 0.5, self.training)
        return F.relu(self.fc1(h))
