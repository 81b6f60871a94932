"""STFT / iSTFT in the ``(re, im)`` pair form of ``remfx_tpu/ops/stft.py``.

The JAX package computes these as DFT matrix products because the TPU
has no complex dtype (PERF_NOTES #1). On the card, complex ``torch.stft``
and ``torch.istft`` (cuFFT) compute the same values; the pair form is
kept at the public functions so that callers and tests compare like
with like. Semantics are ``torch.stft``'s defaults: ``center=True``,
``pad_mode="reflect"``, onesided, NOLA-normalised overlap-add.

Neither cuFFT nor MKL takes bf16 (or fp16). A half-precision signal is
transformed in fp32, with the window in fp32 whatever dtype its buffer
holds, and the result is rounded back to the caller's dtype, as the JAX
package's windowed DFT returns ``x.dtype`` (``remfx_tpu/ops/stft.py:
156, 198-210``). fp32 and fp64 take the FFT as they come.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from remfx_tpu_torch.ops.fft import real_edge_bins


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, computed in float64 and rounded once (as the
    JAX package does), so both packages hold the same fp32 window."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return torch.tensor(w, dtype=dtype, device=device)


def _fft_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the FFT runs in for a signal of ``dtype``."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def stft_ri(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
            center: bool = True, pad_mode: str = "reflect"):
    """STFT of ``x (..., T)`` -> (re, im), each ``(..., n_fft//2+1, n_frames)``,
    in ``x``'s dtype."""
    batch, dtype = x.shape[:-1], x.dtype
    if _fft_dtype(dtype) != dtype:
        x, window = x.float(), window.float()
    z = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length,
        win_length=window.shape[0], window=window, center=center,
        pad_mode=pad_mode, return_complex=True,
    )
    z = z.reshape(*batch, *z.shape[-2:])
    return z.real.to(dtype).contiguous(), z.imag.to(dtype).contiguous()


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
             window: torch.Tensor, center: bool = True,
             length: int | None = None) -> torch.Tensor:
    """Inverse STFT: ``re``/``im`` (..., n_freq, n_frames) -> (..., T) real.

    With ``length``, the output is cut or zero-padded to that length, as
    in the JAX package: past the centred output, samples are zeros.
    (``torch.istft(length=...)`` would instead read on into the overlap-add
    of the right-hand ``center`` padding.)

    The imaginary parts of the DC and Nyquist bins are ignored, as the JAX
    package's inverse DFT ignores them (``ops.fft.real_edge_bins``). The
    output is in ``re``'s dtype."""
    batch, dtype = re.shape[:-2], re.dtype
    if _fft_dtype(dtype) != dtype:
        re, im, window = re.float(), im.float(), window.float()
    z = torch.complex(re, real_edge_bins(im, n_fft, dim=-2)).reshape(-1, *re.shape[-2:])
    y = torch.istft(
        z, n_fft, hop_length, win_length=window.shape[0], window=window,
        center=center,
    )
    if length is not None:
        t = y.shape[-1]
        y = y[..., :length] if t >= length else F.pad(y, (0, length - t))
    return y.to(dtype).reshape(*batch, y.shape[-1])
