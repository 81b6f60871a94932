"""Freeverb reverb — exact FFT-domain evaluation of the comb/allpass bank.

Counterpart of ``remfx_tpu/fx/reverb.py``; parity target pedalboard
``Reverb`` == ``juce::Reverb`` (Freeverb tunings), reference
``RandomPedalboardReverb`` (remfx/effects.py:575-616): ``wet_level =
wet_dry``, ``dry_level = 1 - wet_dry``. JUCE semantics, with static
parameters:

  * 8 parallel damped feedback combs and 4 series allpass sections, input
    gain 0.015;
  * comb lengths ``(tuning * sr) // 44100``; the right channel adds a
    23-sample spread; allpass tunings {556, 441, 341, 225};
  * feedback = room_size * 0.28 + 0.7; damp = damping * 0.4;
  * mono out = wet1 * reverb(x) + 2*dry_level * x with
    wet1 = 3*wet_level * 0.5*(1 + width); stereo cross-mixes the two
    channel banks with wet1 / wet2.

The bank is LTI, so its closed-form response

  comb_L(z) = z^-L (1 - d z^-1) / ((1 - d z^-1) - fb (1-d) z^-L)
  ap_L(z)   = (1.5 z^-L - 1) / (1 - 0.5 z^-L)
  H(z)      = gain * [sum of combs] * product of allpasses

is evaluated at the rfft bins and applied through cuFFT on the card. The
padding comes from the range's maximum room size: at 1.0 the tail is
1,203,567 samples and a 262144-sample chunk takes a 2^21-point FFT. The
angles ``w * L`` are formed in fp32, as the JAX package forms them.
"""

from __future__ import annotations

import math

import torch

from remfx_tpu_torch.fx.base import RandomEffect, uniform
from remfx_tpu_torch.ops.fft import cdiv, cmul, irfft_ri, rfft_ri

COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS = (556, 441, 341, 225)
STEREO_SPREAD = 23
GAIN = 0.015

DEFAULT_RANGES = {
    "min_room_size": 0.0,
    "max_room_size": 1.0,
    "min_damping": 0.0,
    "max_damping": 1.0,
    "min_wet_dry": 0.0,
    "max_wet_dry": 0.7,
    "min_width": 0.0,
    "max_width": 1.0,
}


def sample_params(generator, n, ranges, device=None):
    return {name: uniform(generator, ranges[f"min_{name}"], ranges[f"max_{name}"],
                          n, device)
            for name in ("room_size", "damping", "wet_dry", "width")}


def comb_lengths(sample_rate: int, spread: int = 0):
    return [t * int(sample_rate) // 44100 + spread for t in COMB_TUNINGS]


def allpass_lengths(sample_rate: int, spread: int = 0):
    return [t * int(sample_rate) // 44100 + spread for t in ALLPASS_TUNINGS]


def tail_samples(max_room_size, sample_rate, tol=1e-6):
    fb = min(max_room_size * 0.28 + 0.7, 0.985)
    L = max(comb_lengths(sample_rate))
    return int(math.ceil(L * math.log(tol) / math.log(fb)))


def bank_response_from_lengths(w, comb_Ls, allpass_Ls, feedback, damp):
    """(re, im) of [sum of damped combs] * [product of allpasses] at the
    angles ``w (n_bins,)``, for per-row ``feedback``, ``damp`` ``(B, 1)``
    -> ``(B, n_bins)``."""
    Hr = torch.zeros_like(w)
    Hi = torch.zeros_like(w)
    cw, sw = torch.cos(w), torch.sin(w)
    dr, di_ = 1.0 - damp * cw, damp * sw  # (1 - d z^-1)
    for L in comb_Ls:
        zLr, zLi = torch.cos(w * L), -torch.sin(w * L)
        nr, ni = cmul(zLr, zLi, dr, di_)  # z^-L (1 - d z^-1)
        # (1 - d z^-1) - fb (1-d) z^-L
        er = dr - feedback * (1.0 - damp) * zLr
        ei = di_ - feedback * (1.0 - damp) * zLi
        cr_, ci_ = cdiv(nr, ni, er, ei)
        Hr, Hi = Hr + cr_, Hi + ci_
    for L in allpass_Ls:
        zLr, zLi = torch.cos(w * L), -torch.sin(w * L)
        ar, ai = cdiv(1.5 * zLr - 1.0, 1.5 * zLi, 1.0 - 0.5 * zLr, -0.5 * zLi)
        Hr, Hi = cmul(Hr, Hi, ar, ai)
    return Hr, Hi


def _bank_response(w, feedback, damp, sample_rate, spread):
    Hr, Hi = bank_response_from_lengths(
        w, comb_lengths(sample_rate, spread), allpass_lengths(sample_rate, spread),
        feedback, damp)
    return GAIN * Hr, GAIN * Hi


def render_fft(xb: torch.Tensor, params: dict, sample_rate: int,
               n_fft: int) -> torch.Tensor:
    """``xb (B, C, T)`` with C in {1, 2}; parameters ``(B,)``."""
    T = xb.shape[-1]
    col = {k: params[k][:, None] for k in ("room_size", "damping", "wet_dry", "width")}
    feedback = col["room_size"] * 0.28 + 0.7
    damp = col["damping"] * 0.4
    wet = col["wet_dry"] * 3.0
    dry = (1.0 - params["wet_dry"][:, None, None]) * 2.0
    wet1 = (0.5 * wet * (1.0 + col["width"]))[:, :, None]
    wet2 = (0.5 * wet * (1.0 - col["width"]))[:, :, None]

    w = torch.arange(n_fft // 2 + 1, dtype=torch.float32,
                     device=xb.device) * (2.0 * math.pi / n_fft)
    HrL, HiL = _bank_response(w, feedback, damp, sample_rate, 0)
    if xb.shape[1] == 1:
        Xr, Xi = rfft_ri(xb, n_fft)
        Yr, Yi = cmul(Xr, Xi, HrL[:, None], HiL[:, None])
        out = irfft_ri(Yr, Yi, n_fft)[..., :T]
        return (out * wet1 + xb * dry).to(xb.dtype)
    # stereo: both channel banks driven by the channel sum (JUCE
    # processStereo: input = (L + R) * gain, the gain folded into the bank)
    HrR, HiR = _bank_response(w, feedback, damp, sample_rate, STEREO_SPREAD)
    Mr, Mi = rfft_ri(xb[:, 0:1] + xb[:, 1:2], n_fft)
    outL = irfft_ri(*cmul(Mr, Mi, HrL[:, None], HiL[:, None]), n_fft)[..., :T]
    outR = irfft_ri(*cmul(Mr, Mi, HrR[:, None], HiR[:, None]), n_fft)[..., :T]
    yL = outL * wet1 + outR * wet2 + xb[:, 0:1] * dry
    yR = outR * wet1 + outL * wet2 + xb[:, 1:2] * dry
    return torch.cat([yL, yR], dim=1).to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    pad = tail_samples(ranges["max_room_size"], sample_rate)

    def render(xb, params, sr):
        n_fft = 1 << int(xb.shape[-1] + pad - 1).bit_length()
        return render_fft(xb, params, int(sr), n_fft)

    return RandomEffect("reverb", sample_rate, sample_params, render, ranges, device)
