"""Phaser — JUCE ``dsp::Phaser``-style (6 modulated first-order all-passes).

Counterpart of ``remfx_tpu/fx/phaser.py``; parity target pedalboard
``Phaser``, reference ``RandomPedalboardPhaser`` (remfx/effects.py:418-465).
The reference's own bug is kept: the centre frequency is drawn as
``rand(min, min)``, the range's minimum. Per example, in fp32 as the JAX
package forms it:

    lfo[n] = sin(2π rate n / sr)
    fc[n]  = exp-map of (norm(centre) + 0.5*depth*lfo[n]) over [20, 0.49 sr]
    a[n]   = (tan(π fc/sr) - 1) / (tan(π fc/sr) + 1)

then six all-passes in series, ``y = a*u + u' - a*y'``, with feedback from
the last stage and a linear dry/wet mix. The coefficient is computed here in
PyTorch; the recurrence, a chain of dependent steps with no FFT or scan
shortcut, runs in the hand-written kernel of ``ops/phaser.py`` on the card
(one launch per render) and in its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch

from remfx_tpu_torch.fx.base import RandomEffect, uniform
from remfx_tpu_torch.ops.phaser import phaser

DEFAULT_RANGES = {
    "min_rate_hz": 0.25,
    "max_rate_hz": 5.0,
    "min_depth": 0.1,
    "max_depth": 0.6,
    "min_centre_frequency_hz": 200.0,
    "max_centre_frequency_hz": 600.0,
    "min_feedback": 0.1,
    "max_feedback": 0.6,
    "min_mix": 0.1,
    "max_mix": 0.7,
}
F_LO = 20.0


def sample_params(generator, n, ranges, device=None):
    lo_c = ranges["min_centre_frequency_hz"]
    return {
        "rate_hz": uniform(generator, ranges["min_rate_hz"], ranges["max_rate_hz"],
                           n, device),
        "depth": uniform(generator, ranges["min_depth"], ranges["max_depth"], n, device),
        # the reference's bug kept: rand(min, min) is the minimum
        "centre_frequency_hz": uniform(generator, lo_c, lo_c, n, device),
        "feedback": uniform(generator, ranges["min_feedback"], ranges["max_feedback"],
                            n, device),
        "mix": uniform(generator, ranges["min_mix"], ranges["max_mix"], n, device),
    }


def coefficients(params: dict, T: int, sample_rate: int, device) -> torch.Tensor:
    """The all-passes' coefficient of every example and sample -> (B, T)
    fp32, by the JAX package's ops in its order."""
    f_hi = 0.49 * sample_rate
    col = {k: params[k][:, None] for k in ("rate_hz", "depth", "centre_frequency_hz")}
    n = torch.arange(T, dtype=torch.float32, device=device)
    lfo = torch.sin(2.0 * math.pi * col["rate_hz"] * n / sample_rate)
    norm_centre = torch.log(col["centre_frequency_hz"] / F_LO) / math.log(f_hi / F_LO)
    norm = torch.clamp(norm_centre + 0.5 * col["depth"] * lfo, 0.0, 1.0)
    fc = F_LO * torch.exp(norm * math.log(f_hi / F_LO))
    tant = torch.tan(math.pi * fc / sample_rate)
    return ((tant - 1.0) / (tant + 1.0)).contiguous()


def render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """``xb (B, C, T)``; parameters ``(B,)``."""
    a = coefficients(params, xb.shape[-1], int(sample_rate), xb.device)
    return phaser(xb.float().contiguous(), a, params["feedback"].float().contiguous(),
                  params["mix"].float().contiguous()).to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    return RandomEffect("phaser", sample_rate, sample_params, render, ranges, device)
