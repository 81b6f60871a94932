"""The inverse STFT of the reference, in plain operations.

``torch.istft``'s semantics (``center=True``, a one-sided spectrum, the
overlap-add divided by the summed squared window): an inverse real FFT of
each frame, the window, an overlap-add by ``F.fold``, the division by the
window's own overlap-add, and the centre trim. The imaginary parts of the
DC and Nyquist bins are set to zero first, as the inverse real DFT
defines them: cuFFT's complex-to-real transform reads them where
pocketfft ignores them, so without it the card and the CPU would differ.
It checks nothing that needs the data, so it also runs on meta tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def istft(z: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
          normalized: bool = False, length: int | None = None) -> torch.Tensor:
    """z: (..., n_fft // 2 + 1, frames) complex -> (..., length) real."""
    *batch, _, frames = z.shape
    z = z.reshape(-1, z.shape[-2], frames)
    edge = torch.zeros(z.shape[-2], 1, dtype=torch.bool, device=z.device)
    edge[0] = True
    if n_fft % 2 == 0:
        edge[-1] = True
    z = torch.complex(z.real, torch.where(edge, 0.0, z.imag))
    x = torch.fft.irfft(z, n=n_fft, dim=-2)  # (B, n_fft, frames)
    if normalized:
        x = x * math.sqrt(n_fft)
    x = x * window[:, None]
    total = n_fft + hop * (frames - 1)

    def overlap_add(cols):
        return F.fold(cols, (1, total), (1, n_fft), stride=(1, hop))[:, 0, 0]

    y = overlap_add(x)
    env = overlap_add((window * window)[None, :, None].expand(1, n_fft, frames))
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    start = n_fft // 2
    end = total - n_fft // 2 if length is None else start + length
    y = y[:, start:end]
    if length is not None and y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    return y.reshape(*batch, y.shape[-1])
