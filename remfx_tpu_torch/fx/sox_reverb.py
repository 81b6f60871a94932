"""Sox-style reverb (the reference's alternative ``RandomSoxReverb``).

Counterpart of ``remfx_tpu/fx/sox_reverb.py``; parity target reference
remfx/effects.py:516-572, sox's ``reverb`` effect (the Freeverb variant of
reverb.c) rendered wet-only, then mixed ``x*(1-wet_dry) + y*wet_dry``.
Sox's parameter mapping (reverb.c):

    feedback  = 1 - exp((reverberance - b) / (a*b)),
                a = -1/ln(1-0.3), b = 100/(ln(1-0.98)*a + 1)
    damping   = hf_damping/100 * 0.3 + 0.7
    scale     = room_scale/100 * 0.9 + 0.1
    comb/allpass lengths = round(Freeverb tunings * (rate/44100) * scale)
    pre-delay in ms ahead of the bank; input gain 0.015.

For fixed parameters it is LTI, so it is rendered exactly in the frequency
domain with ``fx/reverb.py``'s bank response, here with per-example lengths
``(B, 1)``, through cuFFT on the card. ``stereo_depth`` is drawn, as the
reference draws it, and unused: every channel goes through the same bank.
The padding comes from the range's maxima: at ``max_room_scale`` 100 and
48 kHz the tail is about 1.2 M samples, so a 262144-sample chunk takes a
2^21-point FFT (``fft_size``).
"""

from __future__ import annotations

import math

import torch

from remfx_tpu_torch.fx.base import RandomEffect, uniform
from remfx_tpu_torch.fx.reverb import (ALLPASS_TUNINGS, COMB_TUNINGS,
                                       bank_response_from_lengths)
from remfx_tpu_torch.ops.fft import cmul, irfft_ri, rfft_ri

DEFAULT_RANGES = {
    "min_reverberance": 10.0,
    "max_reverberance": 100.0,
    "min_high_freq_damping": 0.0,
    "max_high_freq_damping": 100.0,
    "min_wet_dry": 0.0,
    "max_wet_dry": 1.0,
    "min_room_scale": 5.0,
    "max_room_scale": 100.0,
    "min_stereo_depth": 20.0,
    "max_stereo_depth": 100.0,
    "min_pre_delay": 0.0,
    "max_pre_delay": 100.0,
}
PARAMS = ("reverberance", "high_freq_damping", "room_scale", "stereo_depth",
          "wet_dry", "pre_delay")

_A = -1.0 / math.log(1.0 - 0.3)
_B = 100.0 / (math.log(1.0 - 0.98) * _A + 1.0)


def sample_params(generator, n, ranges, device=None):
    return {name: uniform(generator, ranges[f"min_{name}"], ranges[f"max_{name}"],
                          n, device)
            for name in PARAMS}


def fft_size(T: int, ranges: dict, sample_rate) -> int:
    """The FFT length for ``T`` samples and their tail: the longest comb's
    decay to 1e-6 at the worst feedback (0.98, reverberance 100) in the
    largest room, plus the largest pre-delay."""
    L = int(1617 * sample_rate / 44100.0 * (ranges["max_room_scale"] / 100 * 0.9 + 0.1))
    pad = int(L * math.log(1e-6) / math.log(0.98)) + int(
        ranges["max_pre_delay"] / 1000.0 * sample_rate)
    return 1 << int(T + pad - 1).bit_length()


def render_fft(xb: torch.Tensor, params: dict, sample_rate: int,
               n_fft: int) -> torch.Tensor:
    """``xb (B, C, T)``; parameters ``(B,)``."""
    T = xb.shape[-1]
    col = {k: params[k][:, None] for k in PARAMS}
    feedback = 1.0 - torch.exp((col["reverberance"] - _B) / (_A * _B))
    damp = col["high_freq_damping"] / 100.0 * 0.3 + 0.7
    scale = col["room_scale"] / 100.0 * 0.9 + 0.1
    r = sample_rate / 44100.0 * scale

    w = torch.arange(n_fft // 2 + 1, dtype=torch.float32,
                     device=xb.device) * (2.0 * math.pi / n_fft)
    # the tunings scale with the room, so the lengths are per example
    Hr, Hi = bank_response_from_lengths(
        w, [torch.round(L0 * r) for L0 in COMB_TUNINGS],
        [torch.round(L0 * r) for L0 in ALLPASS_TUNINGS], feedback, damp)
    # pre-delay and input gain
    D = col["pre_delay"] / 1000.0 * sample_rate
    pr, pi = torch.cos(w * D), -torch.sin(w * D)
    Hr, Hi = cmul(Hr * 0.015, Hi * 0.015, pr, pi)

    Xr, Xi = rfft_ri(xb, n_fft)
    Yr, Yi = cmul(Xr, Xi, Hr[:, None], Hi[:, None])
    wet = irfft_ri(Yr, Yi, n_fft)[..., :T]
    wd = params["wet_dry"][:, None, None]
    return (xb * (1.0 - wd) + wet * wd).to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}

    def render(xb, params, sr):
        return render_fft(xb, params, int(sr), fft_size(xb.shape[-1], ranges, sample_rate))

    return RandomEffect("sox_reverb", sample_rate, sample_params, render, ranges,
                        device)
