"""Feedback delay — exact FFT-domain evaluation.

Counterpart of ``remfx_tpu/fx/delay.py``; parity target pedalboard
``Delay`` (JUCE ``DelayLine`` with linear interpolation), reference
``RandomPedalboardDelay`` (remfx/effects.py:341-367, with the
``max_delay_sconds`` typo kept at the config surface). Per sample:

    d[n] = (1-f)*u[n-Di] + f*u[n-Di-1]        (pop, linear interp)
    u[n] = x[n] + feedback * d[n]             (push)
    y[n] = (1-mix) * x[n] + mix * d[n]

For fixed parameters this is LTI, so it is evaluated by its transfer
function

    Z(z) = z^{-Di} ((1-f) + f z^{-1});   H = (1-mix) + mix * Z / (1 - fb*Z)

at the rfft bins, through cuFFT on the card. The zero padding comes from
the parameter *ranges* (``tail_samples``), so the wrapped feedback tail
is below 1e-6: at the dataset ranges (1 s, feedback 0.3) the tail is
576,000 samples and a 262144-sample chunk takes a 2^20-point FFT. The
phase ``w * Di`` is formed in fp32, as the JAX package forms it.
"""

from __future__ import annotations

import math

import torch

from remfx_tpu_torch.fx.base import RandomEffect, loguniform, uniform
from remfx_tpu_torch.ops.fft import cdiv, cmul, irfft_ri, rfft_ri

DEFAULT_RANGES = {
    "min_delay_seconds": 0.1,
    "max_delay_sconds": 1.0,  # sic — the reference API's typo is part of the surface
    "min_feedback": 0.05,
    "max_feedback": 0.6,
    "min_mix": 0.0,
    "max_mix": 0.7,
}


def sample_params(generator, n, ranges, device=None):
    return {
        "delay_seconds": loguniform(generator, ranges["min_delay_seconds"],
                                    ranges["max_delay_sconds"], n, device),
        "feedback": uniform(generator, ranges["min_feedback"],
                            ranges["max_feedback"], n, device),
        "mix": uniform(generator, ranges["min_mix"], ranges["max_mix"], n, device),
    }


def tail_samples(max_delay_seconds, max_feedback, sample_rate, tol=1e-6):
    """Pad length that bounds the wrapped feedback tail below ``tol``."""
    fb = min(max(max_feedback, 1e-3), 0.999)
    round_trips = math.ceil(math.log(tol) / math.log(fb)) if fb > tol else 1
    return int(math.ceil(round_trips * max_delay_seconds * sample_rate))


def render_fft(xb: torch.Tensor, delay_samples: torch.Tensor,
               feedback: torch.Tensor, mix: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``xb (B, C, T)``; ``delay_samples``, ``feedback``, ``mix`` ``(B,)``."""
    T = xb.shape[-1]
    w = torch.arange(n_fft // 2 + 1, dtype=torch.float32,
                     device=xb.device) * (2.0 * math.pi / n_fft)
    d = delay_samples[:, None]
    di = torch.floor(d)
    f = d - di
    # Z = e^{-jw*Di} * ((1-f) + f e^{-jw}), per row (B, n_bins)
    ang = w * di
    Zr, Zi = cmul(torch.cos(ang), -torch.sin(ang),
                  (1.0 - f) + f * torch.cos(w), -f * torch.sin(w))
    fb = feedback[:, None]
    Gr, Gi = cdiv(Zr, Zi, 1.0 - fb * Zr, -fb * Zi)
    m = mix[:, None]
    Hr, Hi = (1.0 - m) + m * Gr, m * Gi
    Xr, Xi = rfft_ri(xb, n_fft)
    Yr, Yi = cmul(Xr, Xi, Hr[:, None, :], Hi[:, None, :])
    return irfft_ri(Yr, Yi, n_fft)[..., :T].to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    pad = tail_samples(ranges["max_delay_sconds"], ranges["max_feedback"],
                       sample_rate)

    def render(xb, params, sr):
        n_fft = 1 << int(xb.shape[-1] + pad - 1).bit_length()
        return render_fft(xb, params["delay_seconds"] * sr, params["feedback"],
                          params["mix"], n_fft)

    return RandomEffect("delay", sample_rate, sample_params, render, ranges, device)
