"""OpenUnmix (UMX): BiLSTM spectral masking and its separator.

Counterpart of ``remfx_tpu/models/umx.py`` (the reference's
``OpenUnmixModel``, remfx/models.py:259-304, around sigsep/open-unmix-
pytorch's ``OpenUnmix`` and ``Separator``):

  OpenUnmix: crop bins -> (x + input_mean) * input_scale -> fc1 (no bias)
  -> BN -> tanh -> 3-layer BiLSTM (256 a direction, dropout 0.4 between
  layers in train mode) with a skip concat -> fc2 -> BN -> ReLU -> fc3
  -> BN -> * output_scale + output_mean -> ReLU -> mask * mix.

  UMXSeparator: STFT (n_fft 2048, hop 512, periodic Hann) -> magnitude
  -> OpenUnmix -> with ``niter=0`` and no ``softmask``, the estimate
  with the mixture phase; otherwise the Wiener EM post-filter
  (``ops/wiener.py``) per example, keeping source 0 -> iSTFT at the input
  length.

The BatchNorms are torch's ``BatchNorm1d`` (``models/batchnorm.py``'s,
which also takes bf16 activations beside fp32 running statistics): the
JAX module keeps torch's rule (the running variance updated with the
unbiased batch variance), unlike flax's ``BatchNorm`` that
``models/batchnorm.py`` copies for Cnn14.
``identity_init`` sets ``output_scale`` to 0.1 and ``output_mean`` to 1,
so that the mask starts near 1. Parameter names are the JAX package's and
torch's (``fc1.weight`` (out, in), ``bn1.*``, ``lstm.weight_ih_l{n}``...),
under ``model.`` in the separator.
"""

from __future__ import annotations

import torch
from torch import nn

from remfx_tpu_torch.models.batchnorm import BatchNorm1d
from remfx_tpu_torch.models.lstm import LSTM
from remfx_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from remfx_tpu_torch.ops.wiener import wiener


class OpenUnmix(nn.Module):
    def __init__(self, nb_bins: int = 1025, nb_channels: int = 1,
                 hidden_size: int = 512, nb_layers: int = 3,
                 max_bin: int | None = None, identity_init: bool = False):
        super().__init__()
        self.nb_bins = nb_bins
        self.hidden_size = hidden_size
        self.crop_bins = max_bin or nb_bins
        self.input_mean = nn.Parameter(torch.zeros(self.crop_bins))
        self.input_scale = nn.Parameter(torch.ones(self.crop_bins))
        self.fc1 = nn.Linear(nb_channels * self.crop_bins, hidden_size, bias=False)
        self.bn1 = BatchNorm1d(hidden_size)
        self.lstm = LSTM(hidden_size, hidden_size // 2, num_layers=nb_layers,
                         bidirectional=True, dropout=0.4)
        self.fc2 = nn.Linear(2 * hidden_size, hidden_size, bias=False)
        self.bn2 = BatchNorm1d(hidden_size)
        self.fc3 = nn.Linear(hidden_size, nb_bins * nb_channels, bias=False)
        self.bn3 = BatchNorm1d(nb_bins * nb_channels)
        self.output_scale = nn.Parameter(
            torch.full((nb_bins,), 0.1 if identity_init else 1.0))
        self.output_mean = nn.Parameter(
            torch.full((nb_bins,), 1.0 if identity_init else 0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, F, T) magnitude -> (B, C, F, T) masked magnitude."""
        B, C, _, T = x.shape
        h = x.permute(3, 0, 1, 2)[..., : self.crop_bins]  # (T, B, C, F')
        h = (h + self.input_mean) * self.input_scale
        h = self.fc1(h.reshape(T * B, C * self.crop_bins))
        h = torch.tanh(self.bn1(h)).reshape(T, B, self.hidden_size)
        h = torch.cat([h, self.lstm(h)], dim=-1).reshape(T * B, -1)
        h = torch.relu(self.bn2(self.fc2(h)))
        h = self.bn3(self.fc3(h)).reshape(T, B, C, self.nb_bins)
        h = h * self.output_scale + self.output_mean
        return torch.relu(h.permute(1, 2, 3, 0)) * x


class UMXSeparator(nn.Module):
    """STFT -> OpenUnmix magnitude estimate -> reconstruction -> iSTFT.

    ``niter=0`` (the reference's Separator default) keeps the mixture
    phase; ``niter > 0`` runs the EM refinement, for which a single
    target needs the residual source, so it is appended whenever EM runs
    (and dropped from the output). ``softmask`` starts from the ratio
    mask; ``wiener_win_len`` bounds the frames of each EM window."""

    def __init__(self, n_fft: int = 2048, hop_length: int = 512,
                 nb_channels: int = 1, hidden_size: int = 512, niter: int = 0,
                 softmask: bool = False, residual: bool = False,
                 wiener_win_len: int | None = 300, identity_init: bool = False):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.niter, self.softmask, self.residual = niter, softmask, residual
        self.wiener_win_len = wiener_win_len
        self.model = OpenUnmix(nb_bins=n_fft // 2 + 1, nb_channels=nb_channels,
                               hidden_size=hidden_size, identity_init=identity_init)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio: (B, C, T) -> (B, C, T) estimate."""
        T = audio.shape[-1]
        window = hann_window(self.n_fft, device=audio.device)
        re, im = stft_ri(audio, self.n_fft, self.hop_length, window)
        mag = torch.sqrt(re * re + im * im)
        est = self.model(mag)  # (B, C, F, frames)
        if self.niter == 0 and not self.softmask:
            denom = torch.clamp(mag, min=1e-8)
            yr, yi = est * re / denom, est * im / denom
        else:
            # torch has no bf16 complex type: a bf16 pair runs the EM in
            # complex64 and is rounded back to bf16 after it (the JAX
            # package runs its EM on the bf16 pairs themselves)
            real = torch.promote_types(re.dtype, torch.float32)
            x = torch.complex(re.to(real), im.to(real))
            est = est.to(real)
            ys = []
            # per example, as the JAX package's vmap: the EM's rescale and
            # statistics are the example's own; (frames, F, C, S) in
            for b in range(audio.shape[0]):
                y = wiener(
                    est[b].permute(2, 1, 0)[..., None], x[b].permute(2, 1, 0),
                    niter=self.niter, softmask=self.softmask,
                    residual=self.residual or self.niter > 0,
                    wiener_win_len=self.wiener_win_len)
                ys.append(y[..., 0].permute(2, 1, 0))  # source 0, (C, F, frames)
            y = torch.stack(ys)
            yr, yi = y.real.to(re.dtype), y.imag.to(re.dtype)
        return istft_ri(yr, yi, self.n_fft, self.hop_length, window, length=T)

    def output_length(self, length: int) -> int:
        return length
