"""Real FFTs in the ``(re, im)`` pair form of ``remfx_tpu/ops/fft.py``.

The JAX package evaluates its FFTs as DFT matrix products (with a 4-step
decomposition for long transforms) because the TPU has no complex dtype
(PERF_NOTES #1). The port computes the same transforms with
``torch.fft`` (cuFFT on the card) and keeps the pair form at its public
functions, so that callers and tests compare like with like. All
functions work along the last axis.
"""

from __future__ import annotations

import torch


def rfft_ri(x: torch.Tensor, n: int):
    """Real-input FFT of ``x (..., T)``, cut or zero-padded to ``n`` ->
    (re, im), each ``(..., n//2 + 1)``."""
    z = torch.fft.rfft(x, n=n)
    return z.real.contiguous(), z.imag.contiguous()


def real_edge_bins(im: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``im`` with the DC and (for even ``n``) Nyquist bins of an
    ``n``-point real spectrum zeroed along ``dim``.

    The JAX package's inverse DFTs ignore those imaginary parts (their
    sine terms vanish). A real inverse FFT of a spectrum that is not
    Hermitian there is not defined, and cuFFT and the CPU's FFT then
    disagree, so every inverse of the port zeroes them first."""
    keep = torch.ones(im.shape[dim], dtype=im.dtype, device=im.device)
    keep[0] = 0.0
    if n % 2 == 0:
        keep[-1] = 0.0
    return im * keep.reshape((-1,) + (1,) * (-1 - dim))


def irfft_ri(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``rfft_ri``: ``(..., n//2 + 1)`` re/im -> ``(..., n)``,
    with the imaginary parts at DC and Nyquist ignored (``real_edge_bins``)."""
    return torch.fft.irfft(torch.complex(re, real_edge_bins(im, n)), n=n)


def cmul(ar, ai, br, bi):
    """Complex multiply on re/im pairs."""
    return ar * br - ai * bi, ar * bi + ai * br


def cdiv(ar, ai, br, bi, eps: float = 0.0):
    """Complex divide on re/im pairs (the JAX package's formula, not
    torch's scaled complex division)."""
    d = br * br + bi * bi + eps
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d
