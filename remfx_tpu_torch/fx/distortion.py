"""Distortion — tanh waveshaper with drive gain.

Counterpart of ``remfx_tpu/fx/distortion.py``; parity target pedalboard
``Distortion`` (JUCE), ``y = tanh(x * 10^(drive_db/20))``, as used by the
reference's ``RandomPedalboardDistortion`` (remfx/effects.py:497-513).
Default range -20..12 dB; the dataset config narrows it to 8..25 dB
(cfg/effects/all.yaml:15-19).
"""

from __future__ import annotations

import torch

from remfx_tpu_torch.fx.base import RandomEffect, uniform

DEFAULT_RANGES = {"min_drive_db": -20.0, "max_drive_db": 12.0}


def sample_params(generator, n, ranges, device=None):
    return {"drive_db": uniform(generator, ranges["min_drive_db"],
                                ranges["max_drive_db"], n, device)}


def render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """``xb (B, C, T)``, ``drive_db (B,)``."""
    gain = 10.0 ** (params["drive_db"] / 20.0)
    return torch.tanh(xb * gain[:, None, None])


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    return RandomEffect("distortion", sample_rate, sample_params, render, ranges,
                        device)
