"""FFT-domain application of LTI systems, in the ``(re, im)`` pair form.

Counterpart of ``remfx_tpu/ops/fftfilt.py``: a linear time-invariant
effect (an EQ's biquad cascade, a feedback delay, Freeverb) has a closed
form frequency response, so ``y = irfft(rfft(pad(x)) * H)`` with enough
zero padding that the wrapped tail of the impulse response is below fp32
noise. Transforms go through ``ops/fft.py`` (cuFFT on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from remfx_tpu_torch.ops.fft import cdiv, cmul, irfft_ri, rfft_ri


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def apply_lti_ri(x: torch.Tensor, Hr: torch.Tensor, Hi: torch.Tensor,
                 n_fft: int) -> torch.Tensor:
    """Filter ``x (..., T)`` by the response ``(Hr, Hi)`` at the rfft bins
    of an ``n_fft``-point FFT -> the first T samples."""
    T = x.shape[-1]
    Xr, Xi = rfft_ri(x, n_fft)
    Yr, Yi = cmul(Xr, Xi, Hr, Hi)
    return irfft_ri(Yr, Yi, n_fft)[..., :T].to(x.dtype)


def rfft_omega(n_fft: int, device=None):
    """(cos, -sin) of the rfft bin angles, the re/im of ``z^-1``. The
    angles are formed in float64 and rounded once, as in the JAX package."""
    w = np.arange(n_fft // 2 + 1) * (2.0 * np.pi / n_fft)
    return (torch.tensor(np.cos(w), dtype=torch.float32, device=device),
            torch.tensor(-np.sin(w), dtype=torch.float32, device=device))


def delay_response(z1r, z1i, delay_samples):
    """``z^-D`` for a (possibly fractional) ``D``: ``e^{-j w D}``, with w
    recovered from ``z^-1`` as the JAX package does."""
    ang = torch.atan2(-z1i, z1r) * delay_samples
    return torch.cos(ang), -torch.sin(ang)


def biquad_response_ri(b: torch.Tensor, a: torch.Tensor, z1r: torch.Tensor,
                       z1i: torch.Tensor):
    """``H(z)`` of one biquad at the points ``z^-1 = (z1r, z1i)``; ``b``/``a``
    ``(..., 3)``."""
    z2r, z2i = cmul(z1r, z1i, z1r, z1i)
    nr = b[..., 0:1] + b[..., 1:2] * z1r + b[..., 2:3] * z2r
    ni = b[..., 1:2] * z1i + b[..., 2:3] * z2i
    dr = a[..., 0:1] + a[..., 1:2] * z1r + a[..., 2:3] * z2r
    di = a[..., 1:2] * z1i + a[..., 2:3] * z2i
    return cdiv(nr, ni, dr, di)


def cascade_response_ri(bs, aas, z1r, z1i):
    """Product of the responses of a biquad cascade."""
    Hr = torch.ones_like(z1r)
    Hi = torch.zeros_like(z1i)
    for b, a in zip(bs, aas):
        Hr, Hi = cmul(Hr, Hi, *biquad_response_ri(b, a, z1r, z1i))
    return Hr, Hi
