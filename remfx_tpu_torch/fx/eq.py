"""Random parametric EQ — low shelf, N peaking bands, high shelf.

Counterpart of ``remfx_tpu/fx/eq.py``; parity target the reference's
``RandomParametricEQ`` + ``parametric_eq`` (remfx/effects.py:94-214), an
RBJ biquad cascade run through ``scipy.signal.lfilter``. As in the JAX
package, the cascade's closed-form response is applied in the frequency
domain (``ops/fftfilt.py``) with a ``2 T`` FFT (2^20 points at T =
262144); the bin angles are formed in float64 and rounded once
(``rfft_omega``).
"""

from __future__ import annotations

import torch

from remfx_tpu_torch.fx.base import RandomEffect, loguniform, uniform
from remfx_tpu_torch.ops.biquad import biquad_coeffs
from remfx_tpu_torch.ops.fft import cmul
from remfx_tpu_torch.ops.fftfilt import apply_lti_ri, biquad_response_ri, rfft_omega

DEFAULT_RANGES = {
    "num_bands": 3,
    "min_gain_db": -6.0,
    "max_gain_db": 6.0,
    "min_cutoff_freq": 1000.0,
    "max_cutoff_freq": 10000.0,
    "min_q_factor": 0.1,
    "max_q_factor": 4.0,
}


def sample_params(generator, n, ranges, device=None):
    """Shelves ``(n,)``; bands ``(n, num_bands)``."""
    bands = int(ranges["num_bands"])
    g, q = (ranges["min_gain_db"], ranges["max_gain_db"]), (ranges["min_q_factor"],
                                                           ranges["max_q_factor"])

    def band(draw, lo, hi):
        return draw(generator, lo, hi, n * bands).reshape(n, bands).to(device)

    return {
        "low_shelf_gain_db": uniform(generator, *g, n, device),
        "low_shelf_cutoff_freq": loguniform(generator, 20.0, 200.0, n, device),
        "low_shelf_q_factor": uniform(generator, *q, n, device),
        "high_shelf_gain_db": uniform(generator, *g, n, device),
        "high_shelf_cutoff_freq": loguniform(generator, 8000.0, 16000.0, n, device),
        "high_shelf_q_factor": uniform(generator, *q, n, device),
        "band_gains_db": band(uniform, *g),
        "band_cutoff_freqs": band(loguniform, ranges["min_cutoff_freq"],
                                  ranges["max_cutoff_freq"]),
        "band_q_factors": band(uniform, *q),
    }


def render(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """``xb (B, C, T)``; shelves ``(B,)``, bands ``(B, num_bands)``."""
    n_fft = 1 << int(2 * xb.shape[-1] - 1).bit_length()
    z1r, z1i = rfft_omega(n_fft, xb.device)
    sections = [(params["low_shelf_gain_db"], params["low_shelf_cutoff_freq"],
                 params["low_shelf_q_factor"], "low_shelf")]
    sections += [(params["band_gains_db"][:, i], params["band_cutoff_freqs"][:, i],
                  params["band_q_factors"][:, i], "peaking")
                 for i in range(params["band_gains_db"].shape[-1])]
    sections.append((params["high_shelf_gain_db"], params["high_shelf_cutoff_freq"],
                     params["high_shelf_q_factor"], "high_shelf"))
    Hr = Hi = None
    for gain, cutoff, q, kind in sections:
        b, a = biquad_coeffs(gain, cutoff, q, sample_rate, kind)  # (B, 3)
        hr, hi = biquad_response_ri(b, a, z1r, z1i)  # (B, n_bins)
        Hr, Hi = (hr, hi) if Hr is None else cmul(Hr, Hi, hr, hi)
    return apply_lti_ri(xb, Hr[:, None], Hi[:, None], n_fft)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    return RandomEffect("parametric_eq", sample_rate, sample_params, render, ranges,
                        device)
