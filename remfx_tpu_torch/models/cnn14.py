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
parameters, so it has no parameters here either.

Train mode: the BatchNorms train as flax's (``models/batchnorm.py``), and
with ``specaugment`` each example gets one frequency and one time mask
(``remfx_tpu/models/cnn14.py:55-61,106-117``): width ~ U[0, param), start
~ U[0, length - width), drawn from the ``generator`` passed to
``forward`` (the default generator when none is). Dropout draws from
torch's default generator. A rank's part of a split batch draws both at
the global batch's shape and keeps its rows. At another ``sample_rate`` the input is
resampled to ``model_sample_rate`` first (``ops/resample.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.batchnorm import BatchNorm2d
from remfx_tpu_torch.ops.mel import MelSpectrogram
from remfx_tpu_torch.ops.resample import resample
from remfx_tpu_torch.parallel.mesh import current_split
from remfx_tpu_torch.utils.device import cpu_bf16_convolutions


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_channels)

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


def mask_from_draws(width: torch.Tensor, u: torch.Tensor, length: int) -> torch.Tensor:
    """SpecAugment's mask (True = masked) of each row from its draws:
    ``width`` ~ U[0, param) and ``u`` ~ U[0, 1), both ``(B,)`` float32; the
    mask starts at ``u * (length - width)`` (``_rand_mask`` of the JAX
    package)."""
    start = u * (length - width)
    idx = torch.arange(length, dtype=torch.float32, device=width.device)
    return (idx >= start[:, None]) & (idx < (start + width)[:, None])


def draw_masks(generator, batch: int, n_mel: int, n_time: int,
               freq_mask_param: float, time_mask_param: float, device=None):
    """-> (frequency masks (B, n_mel), time masks (B, n_time)), each row's
    width and start drawn from ``generator`` (on the CPU)."""
    def draw(length, param):
        width = torch.rand(batch, generator=generator) * float(param)
        u = torch.rand(batch, generator=generator)
        return mask_from_draws(width, u, length).to(device)

    return draw(n_mel, freq_mask_param), draw(n_time, time_mask_param)


def apply_masks(m: torch.Tensor, fmask: torch.Tensor, tmask: torch.Tensor):
    """Zero the masked mel bands and frames of ``m (B, mel, time)``."""
    m = torch.where(fmask[:, :, None], 0.0, m)
    return torch.where(tmask[:, None, :], 0.0, m)


class Cnn14(nn.Module):
    def __init__(
        self,
        num_classes: int,
        sample_rate: float,
        model_sample_rate: float,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_mels: int = 128,
        specaugment: bool = False,
        freq_mask_param: int = 64,
        time_mask_param: int = 128,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.model_sample_rate = model_sample_rate
        self.specaugment = specaugment
        self.freq_mask_param = freq_mask_param
        self.time_mask_param = time_mask_param
        self.melspec = MelSpectrogram(model_sample_rate, n_fft, hop_length, n_mels)
        widths = (64, 128, 256, 512, 1024, 2048)
        for i, (cin, cout) in enumerate(zip((1,) + widths[:-1], widths)):
            self.add_module(f"conv_block{i + 1}", ConvBlock(cin, cout))
        self.fc1 = nn.Linear(2048, 2048)
        self.heads = nn.ModuleList(nn.Linear(2048, 1) for _ in range(num_classes))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """x: (B, 1, T) or (B, T) -> (B, num_classes) sigmoid probs."""
        h = self.embed(x, generator)
        return torch.cat([torch.sigmoid(head(h)) for head in self.heads], dim=-1)

    def front_end(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B, 1, T) or (B, T) -> the standardised mel (B, mel, time), with
        SpecAugment's masks in train mode."""
        if x.dim() == 3:
            x = x[:, 0, :]
        if self.sample_rate != self.model_sample_rate:
            x = resample(x, int(self.sample_rate), int(self.model_sample_rate))
        m = self.melspec(x)  # (B, mel, time)
        if self.specaugment and self.training:
            # a rank's part of a split batch draws the global batch's
            # masks and keeps its rows, so N ranks draw as one device
            rows = current_split()
            n = m.shape[0] if rows is None else rows.total
            masks = draw_masks(generator, n, m.shape[1], m.shape[2],
                               self.freq_mask_param, self.time_mask_param, m.device)
            if rows is not None:
                masks = [rows.take(t) for t in masks]
            m = apply_masks(m, *masks)
        # per-example standardisation over (mel, time), ddof=1 like torch.std
        mean = m.mean(dim=(1, 2), keepdim=True)
        n = m.shape[1] * m.shape[2]
        var = ((m - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
        # a silent clip has var 0; real spectrograms sit far above the floor
        return (m - mean) / torch.clamp(torch.sqrt(var), min=1e-6)

    def embed(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """The 2048-d post-fc1 ReLU features (``forward``'s trunk). A bf16
        call on the CPU runs under ``cpu_bf16_convolutions``."""
        with cpu_bf16_convolutions(x):
            h = self.front_end(x, generator)[:, None]  # (B, 1, mel, time)
            for i in range(1, 6):
                h = getattr(self, f"conv_block{i}")(h, (2, 2))
                h = dropout(h, 0.2, self.training)
            h = dropout(self.conv_block6(h, (1, 1)), 0.2, self.training)
        # (B, C, mel', time'): reduce time (mean), then mel (max + mean)
        h = h.mean(dim=3)
        h = h.max(dim=2).values + h.mean(dim=2)
        h = dropout(h, 0.5, self.training)
        return F.relu(self.fc1(h))


def dropout(h: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """``F.dropout``; a rank's part of a split batch (``parallel.split_batch``)
    draws the global batch's mask, as ``F.dropout`` of a tensor of that
    shape does, and keeps its rows, so N ranks drop what one device does."""
    rows = current_split()
    if not training or rows is None:
        return F.dropout(h, p, training)
    scale = F.dropout(h.new_ones((rows.total,) + h.shape[1:]), p, True)
    return h * rows.take(scale)
