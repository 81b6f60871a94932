"""STFT / iSTFT in the ``(re, im)`` pair form of ``remfx_tpu/ops/stft.py``.

The JAX package computes these as DFT matrix products because the TPU
has no complex dtype (PERF_NOTES #1). On the card, complex ``torch.stft``
and ``torch.istft`` (cuFFT) compute the same values; the pair form is
kept at the public functions so that callers and tests compare like
with like. Semantics are ``torch.stft``'s defaults: ``center=True``,
``pad_mode="reflect"``, onesided, NOLA-normalised overlap-add.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, computed in float64 and rounded once (as the
    JAX package does), so both packages hold the same fp32 window."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return torch.tensor(w, dtype=dtype, device=device)


def stft_ri(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
            center: bool = True, pad_mode: str = "reflect"):
    """STFT of ``x (..., T)`` -> (re, im), each ``(..., n_fft//2+1, n_frames)``."""
    batch = x.shape[:-1]
    z = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length,
        win_length=window.shape[0], window=window, center=center,
        pad_mode=pad_mode, return_complex=True,
    )
    z = z.reshape(*batch, *z.shape[-2:])
    return z.real.contiguous(), z.imag.contiguous()


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
             window: torch.Tensor, center: bool = True,
             length: int | None = None) -> torch.Tensor:
    """Inverse STFT: ``re``/``im`` (..., n_freq, n_frames) -> (..., T) real.

    With ``length``, the output is cut or zero-padded to that length, as
    in the JAX package: past the centred output, samples are zeros.
    (``torch.istft(length=...)`` would instead read on into the overlap-add
    of the right-hand ``center`` padding.)

    The imaginary parts of the DC and Nyquist bins are ignored, as the JAX
    package's inverse DFT ignores them (their sine rows are zero). They
    are zeroed before the inverse FFT: a real inverse FFT of a spectrum
    that is not Hermitian there is not defined, and cuFFT and the CPU's
    FFT then disagree."""
    batch = re.shape[:-2]
    keep = torch.ones(im.shape[-2], 1, dtype=im.dtype, device=im.device)
    keep[0] = 0.0
    if n_fft % 2 == 0:
        keep[-1] = 0.0
    z = torch.complex(re, im * keep).reshape(-1, *re.shape[-2:])
    y = torch.istft(
        z, n_fft, hop_length, win_length=window.shape[0], window=window,
        center=center,
    )
    if length is not None:
        t = y.shape[-1]
        y = y[..., :length] if t >= length else F.pad(y, (0, length - t))
    return y.reshape(*batch, y.shape[-1])
