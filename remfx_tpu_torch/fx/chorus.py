"""Chorus — JUCE ``dsp::Chorus`` semantics (time-varying fractional delay).

Counterpart of ``remfx_tpu/fx/chorus.py``; parity target pedalboard
``Chorus``, reference ``RandomPedalboardChorus`` (remfx/effects.py:
370-415). Per sample, with one sine LFO shared by the channels:

    delay[n] = max(1 + 0.5*depth*sin(2π rate n/sr), 0) * centre_ms/1000*sr
    u[n]     = x[n] - feedback * y[n-1]          (negative feedback in)
    y[n]     = (1-f)*u[n-Di] + f*u[n-Di-1]       (linear-interp pop)
    out[n]   = (1-mix)*x[n] + mix*y[n]

The modulated delay makes it time-varying (no FFT shortcut), but the
least delay the ranges allow bounds the feedback lag from below, so time
runs in chunks of W samples, W under that least delay: inside a chunk
every tap reads samples of earlier chunks only, and the whole chunk is
one vectorised step over the batch. At the dataset ranges W = 128, so a
262144-sample chunk takes 2048 sequential steps of six small tensor ops
each: on the card this loop is bound by kernel launches. The taps
use integer positions (no fp32 position loss at large n), as in the JAX
package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from remfx_tpu_torch.fx.base import RandomEffect, uniform

DEFAULT_RANGES = {
    "min_rate_hz": 0.25,
    "max_rate_hz": 4.0,
    "min_depth": 0.0,
    "max_depth": 0.6,
    "min_centre_delay_ms": 5.0,
    "max_centre_delay_ms": 10.0,
    "min_feedback": 0.1,
    "max_feedback": 0.6,
    "min_mix": 0.1,
    "max_mix": 0.7,
}


def sample_params(generator, n, ranges, device=None):
    return {name: uniform(generator, ranges[f"min_{name}"], ranges[f"max_{name}"],
                          n, device)
            for name in ("rate_hz", "depth", "centre_delay_ms", "feedback", "mix")}


def chunk_size(ranges, sample_rate) -> int:
    """Largest power of two strictly below the least possible delay (at
    most 512). Ranges whose least delay reaches about 0 are refused: the
    chunked render is right only when every tap reads an earlier chunk."""
    min_delay_ms = ranges["min_centre_delay_ms"] * max(
        1.0 - 0.5 * ranges["max_depth"], 0.0)
    min_delay = min_delay_ms / 1000.0 * sample_rate
    w = 1
    while w * 2 < min_delay and w < 512:
        w *= 2
    if w < 8:
        raise ValueError(f"chorus ranges give min delay {min_delay:.1f} samples; "
                         "too small for chunked rendering")
    return w


def render_chunked(xb: torch.Tensor, params: dict, sample_rate: int,
                   W: int) -> torch.Tensor:
    """``xb (B, C, T)``; parameters ``(B,)``; chunks of ``W`` samples.

    ``u`` and ``y`` live one sample late in buffers whose slot 0 holds
    the zero that every tap before the start reads (the JAX package's
    ``where(pi >= 0, ..., 0)``), so that a chunk is one gather of both
    taps and five elementwise ops, two of them writing in place."""
    B, C, T = xb.shape
    n_chunks = -(-T // W)
    Tp = n_chunks * W
    xp = F.pad(xb, (0, Tp - T))
    col = {k: v[:, None] for k, v in params.items()}

    # the delay in float64, rounded once, so that every device gives the
    # same taps: in fp32 an ulp of the LFO's phase (CUDA divides by a
    # scalar as a product with its reciprocal) moves the taps, and put
    # render_batch of white noise 1.4e-4 of its peak from the CPU
    p64 = {k: v.to(torch.float64) for k, v in col.items()}
    n = torch.arange(Tp, dtype=torch.float64, device=xb.device)
    lfo = torch.sin(2.0 * math.pi * p64["rate_hz"] * n / sample_rate)
    delay = (torch.clamp_min(1.0 + 0.5 * p64["depth"] * lfo, 0.0)
             * p64["centre_delay_ms"] / 1000.0 * sample_rate).to(torch.float32)
    # JUCE: Di = floor(D), f = D - Di; taps u[n-Di], u[n-Di-1], read at
    # buffer slots n-Di+1 and n-Di (slot 0 for any position before 0)
    di = torch.floor(delay).to(torch.int64)
    frac = (delay - di.to(torch.float32))[:, None, :]
    one_minus = 1.0 - frac
    pos = torch.arange(Tp, device=xb.device) - di
    taps = torch.cat([(pos + 1).clamp_min(0).view(B, n_chunks, W),
                      pos.clamp_min(0).view(B, n_chunks, W)], dim=-1)  # (B, chunks, 2W)

    u = torch.zeros(B, C, Tp + 1, dtype=xp.dtype, device=xb.device)
    y = torch.zeros(B, C, Tp + 1, dtype=xp.dtype, device=xb.device)
    fb = col["feedback"][:, :, None]
    for i in range(n_chunks):
        s = slice(i * W, (i + 1) * W)
        s1 = slice(i * W + 1, (i + 1) * W + 1)
        tap = torch.gather(u, 2, taps[:, None, i].expand(B, C, 2 * W))
        torch.add(one_minus[..., s] * tap[..., :W], frac[..., s] * tap[..., W:],
                  out=y[..., s1])
        # u[n] = x[n] - feedback * y[n-1]
        torch.sub(xp[..., s], fb * y[..., s], out=u[..., s1])
    mix = col["mix"][:, :, None]
    return ((1.0 - mix) * xp + mix * y[..., 1:])[..., :T].to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    ranges = {**DEFAULT_RANGES, **overrides}
    W = chunk_size(ranges, sample_rate)

    def render(xb, params, sr):
        return render_chunked(xb, params, int(sr), W)

    return RandomEffect("chorus", sample_rate, sample_params, render, ranges, device)
