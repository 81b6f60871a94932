"""Limiter, volume automation, stereo widener and loudness normalisation.

Counterpart of ``remfx_tpu/fx/dynamics.py``; parity targets in the
reference's remfx/effects.py:

  * ``RandomPedalboardLimiter`` (468-494): JUCE ``dsp::Limiter`` = two
    cascaded JUCE compressors (stage 1 fixed: -10 dB, ratio 4, attack
    2 ms, release 200 ms; stage 2: the drawn threshold and release, ratio
    1000, attack 0.001 ms), then a hard clip to [-1, 1]. Each stage is
    ``compressor.render_batch``, so on the card the limiter launches the
    envelope kernel twice per call (the JAX package runs the scan twin
    ``envelope_scan`` here). Stage 2's attack gives ``exp(-130.9)``,
    which is 0 in fp32: ``cte_at = 0``.
  * ``RandomVolumeAutomation`` (255-294): 1-3 piecewise-linear gain ramps
    with Dirichlet-split lengths; a tail past the filled samples keeps
    0 dB.
  * ``RandomStereoWidener`` (217-252): mid/side scaled by 2(1-w) and 2w.
  * ``LoudnessNormalize`` (619-629): the BS.1770 gain to a target LUFS.
"""

from __future__ import annotations

import numpy as np
import torch

from remfx_tpu_torch.fx import compressor
from remfx_tpu_torch.fx.base import RandomEffect, randint, uniform
from remfx_tpu_torch.ops.loudness import loudness_normalize

# ---------------------------------------------------------------- limiter

LIMITER_RANGES = {
    "min_threshold_db": -32.0,
    "max_threshold_db": -6.0,
    "min_release_ms": 10.0,
    "max_release_ms": 300.0,
}


def limiter_sample_params(generator, n, ranges, device=None):
    return {
        "threshold_db": uniform(generator, ranges["min_threshold_db"],
                                ranges["max_threshold_db"], n, device),
        "release_ms": uniform(generator, ranges["min_release_ms"],
                              ranges["max_release_ms"], n, device),
    }


def limiter_render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """``xb (B, C, T)``; ``threshold_db``, ``release_ms`` ``(B,)``."""
    sr = int(sample_rate)

    def const(v):
        return torch.full((xb.shape[0],), v, dtype=torch.float32, device=xb.device)

    y = compressor.render_batch(xb, {
        "threshold_db": const(-10.0), "ratio": const(4.0),
        "attack_ms": const(2.0), "release_ms": const(200.0)}, sr)
    y = compressor.render_batch(y, {
        "threshold_db": params["threshold_db"], "ratio": const(1000.0),
        "attack_ms": const(0.001), "release_ms": params["release_ms"]}, sr)
    return torch.clamp(y, -1.0, 1.0).to(xb.dtype)


def make_limiter(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**LIMITER_RANGES, **overrides}
    return RandomEffect("limiter", sample_rate, limiter_sample_params,
                        limiter_render, ranges, device)


# ------------------------------------------------------- volume automation

VOLUME_RANGES = {
    "min_segments": 1,
    "max_segments": 3,
    "min_gain_db": -6.0,
    "max_gain_db": 6.0,
}


def volume_sample_params(generator, n, ranges, device=None):
    """Segment count, Dirichlet fractions over the active segments, and
    end gains. The Dirichlet's gamma draws come from a numpy
    ``Generator`` seeded by one draw of ``generator`` (torch's gamma
    sampler takes no generator), in log space as
    ``log G(a) = log G(a + 1) + log(U) / a``, which stays finite for the
    small alphas where a gamma draw underflows to 0. Inactive segments
    are masked to ``-inf`` before the softmax, so their fractions are
    exactly 0 (as in the JAX package)."""
    max_seg = int(ranges["max_segments"])
    num_segments = randint(generator, int(ranges["min_segments"]), max_seg, n)
    alphas = uniform(generator, 0.0, 10.0, n * max_seg).reshape(n, max_seg)
    alphas = alphas.clamp_min(1e-3).double().numpy()
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    rng = np.random.default_rng(seed)
    logg = (np.log(rng.gamma(alphas + 1.0))
            + np.log1p(-rng.random(alphas.shape)) / alphas)
    active = np.arange(max_seg)[None, :] < num_segments.numpy()[:, None]
    fractions = torch.softmax(
        torch.from_numpy(np.where(active, logg, -np.inf)), dim=-1).float()
    end_gains = uniform(generator, ranges["min_gain_db"], ranges["max_gain_db"],
                        n * max_seg).reshape(n, max_seg)
    return {"num_segments": num_segments.to(device),
            "fractions": fractions.to(device),
            "end_gains_db": end_gains.to(device)}


def volume_render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """``xb (B, C, T)``; ``num_segments (B,)``, ``fractions`` and
    ``end_gains_db`` ``(B, S)``."""
    T = xb.shape[-1]
    fractions = params["fractions"]
    seg_len = torch.floor(T * fractions).to(torch.int32)  # (B, S)
    starts = torch.cumsum(seg_len, dim=-1) - seg_len
    n = torch.arange(T, dtype=torch.float32, device=xb.device)
    gain_db = torch.zeros(xb.shape[0], T, dtype=torch.float32, device=xb.device)
    start_gain = torch.zeros(xb.shape[0], 1, dtype=torch.float32, device=xb.device)
    for i in range(fractions.shape[-1]):
        L, s = seg_len[:, i:i + 1], starts[:, i:i + 1]
        end_gain = params["end_gains_db"][:, i:i + 1]
        active = (i < params["num_segments"])[:, None]
        # linspace(start, end, L): g[k] = start + (end - start) * k / (L - 1)
        denom = torch.clamp_min(L - 1, 1).to(torch.float32)
        seg_gain = start_gain + (end_gain - start_gain) * (n - s.to(torch.float32)) / denom
        in_seg = (n >= s) & (n < s + L) & active
        gain_db = torch.where(in_seg, seg_gain, gain_db)
        start_gain = torch.where(active & (L > 0), end_gain, start_gain)
    return (xb * (10.0 ** (gain_db / 20.0))[:, None, :]).to(xb.dtype)


def make_volume_automation(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**VOLUME_RANGES, **overrides}
    return RandomEffect("volume_automation", sample_rate, volume_sample_params,
                        volume_render, ranges, device)


# --------------------------------------------------------- stereo widener

WIDENER_RANGES = {"min_width": 0.0, "max_width": 1.0}


def widener_sample_params(generator, n, ranges, device=None):
    return {"width": uniform(generator, ranges["min_width"], ranges["max_width"],
                             n, device)}


def stereo_widener(xb: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """``xb (B, 2, T)``, ``width (B,)``: mid scaled by 2(1 - w), side by 2w."""
    sqrt2 = np.sqrt(2.0)
    left, right = xb[:, 0], xb[:, 1]
    w = width[:, None]
    mid = (left + right) / sqrt2 * (2.0 * (1.0 - w))
    side = (left - right) / sqrt2 * (2.0 * w)
    return torch.stack([(mid + side) / sqrt2, (mid - side) / sqrt2], dim=1)


def widener_render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    return stereo_widener(xb, params["width"]).to(xb.dtype)


def make_stereo_widener(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**WIDENER_RANGES, **overrides}
    return RandomEffect("stereo_widener", sample_rate, widener_sample_params,
                        widener_render, ranges, device)


# ------------------------------------------------------ loudness normalize

class LoudnessNormalize:
    """Deterministic LUFS normaliser (reference remfx/effects.py:619-629),
    per example of a batch ``(..., C, T)``."""

    def __init__(self, sample_rate, target_lufs_db: float = -32.0):
        self.sample_rate = int(sample_rate)
        self.target_lufs_db = target_lufs_db

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return loudness_normalize(x, self.sample_rate, self.target_lufs_db)
