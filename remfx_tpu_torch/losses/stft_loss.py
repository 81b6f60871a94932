"""Multi-resolution STFT loss, auraloss-compatible.

Counterpart of ``remfx_tpu/losses/stft_loss.py``: ``auraloss.freq.
MultiResolutionSTFTLoss`` as the reference builds it (remfx/models.py:
35-44): FFT sizes 1024/2048/512, hops 120/240/50, Hann windows of
600/1200/240 centre-padded to the FFT size, w_sc = w_log_mag = 1,
eps 1e-8, ``scale=None`` (so ``n_bins`` and ``sample_rate`` are accepted
and ignored), mean over the batch and then over the resolutions.

Per resolution:
    mag = sqrt(clamp(re^2 + im^2, min=eps))        in fp32
    sc  = mean over items of ||mag_y - mag_x||_F / ||mag_y||_F
    lm  = mean(|log mag_x - log mag_y|)
    loss = sc + lm
"""

from __future__ import annotations

import torch

from remfx_tpu_torch.ops.stft import hann_window, stft_ri


def _stft_mag(x, n_fft, hop, window, eps):
    re, im = stft_ri(x, n_fft, hop, window)
    re, im = re.float(), im.float()
    return torch.sqrt(torch.clamp(re * re + im * im, min=eps))


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
              win_length: int, w_sc: float = 1.0, w_log_mag: float = 1.0,
              eps: float = 1e-8) -> torch.Tensor:
    """One-resolution STFT loss between input ``x`` and target ``y``. A
    bf16 input is transformed in fp32 (torch's FFTs take no bf16), where
    the JAX package runs its DFT-as-matmul in bf16."""
    if x.dtype == torch.bfloat16:
        x, y = x.float(), y.float()
    window = hann_window(win_length, dtype=x.dtype, device=x.device)
    mag_x = _stft_mag(x, n_fft, hop, window, eps)
    mag_y = _stft_mag(y, n_fft, hop, window, eps)
    # Frobenius norms over each item's (freq, time) matrix, then the mean
    # of the ratio over the batch
    diff = torch.sqrt(((mag_y - mag_x) ** 2).sum(dim=(-2, -1)))
    denom = torch.sqrt((mag_y ** 2).sum(dim=(-2, -1)))
    sc = (diff / denom).mean()
    lm = (torch.log(mag_x) - torch.log(mag_y)).abs().mean()
    return w_sc * sc + w_log_mag * lm


DEFAULT_FFT_SIZES = (1024, 2048, 512)
DEFAULT_HOP_SIZES = (120, 240, 50)
DEFAULT_WIN_LENGTHS = (600, 1200, 240)


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               fft_sizes=DEFAULT_FFT_SIZES,
                               hop_sizes=DEFAULT_HOP_SIZES,
                               win_lengths=DEFAULT_WIN_LENGTHS) -> torch.Tensor:
    """Mean over resolutions of ``stft_loss``; ``x``/``y`` (..., T), the
    leading dims folded into the batch."""
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        total = total + stft_loss(x, y, n_fft, hop, win)
    return total / len(fft_sizes)


class STFTLoss:
    def __init__(self, fft_size=1024, hop_size=256, win_length=1024):
        self.fft_size, self.hop_size, self.win_length = fft_size, hop_size, win_length

    def __call__(self, x, y):
        return stft_loss(x, y, self.fft_size, self.hop_size, self.win_length)


class MultiResolutionSTFTLoss:
    """The reference's loss object; ``n_bins``/``sample_rate`` are
    accepted and ignored, as auraloss does at ``scale=None``."""

    def __init__(self, fft_sizes=DEFAULT_FFT_SIZES, hop_sizes=DEFAULT_HOP_SIZES,
                 win_lengths=DEFAULT_WIN_LENGTHS, n_bins=None, sample_rate=None,
                 **_ignored):
        self.fft_sizes = tuple(fft_sizes)
        self.hop_sizes = tuple(hop_sizes)
        self.win_lengths = tuple(win_lengths)

    def __call__(self, x, y):
        return multi_resolution_stft_loss(x, y, self.fft_sizes, self.hop_sizes,
                                          self.win_lengths)
