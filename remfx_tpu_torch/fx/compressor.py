"""Compressor — JUCE ``dsp::Compressor`` semantics.

Counterpart of ``remfx_tpu/fx/compressor.py``. Per sample:

    env[n]  = ballistics(|x[n]|):   env = xa + cte*(env' - xa),
              cte = cteAT if xa > env' else cteRL,
              cteX = exp(-2π*1000 / (sr * time_ms))   (0 if time < 1e-3 ms)
    gain[n] = 1                      if env < thresh_lin
              (env/thresh)^(1/ratio - 1)  otherwise
    y[n]    = gain[n] * x[n]

Both ``render`` and ``render_batch`` run the envelope through
``ops.envelope.envelope``: the hand-written CUDA kernel for a tensor on the
card, its plain version for a tensor on the CPU.
"""

from __future__ import annotations

import math

import torch

from remfx_tpu_torch.fx.base import RandomEffect, uniform
from remfx_tpu_torch.ops.envelope import envelope

DEFAULT_RANGES = {
    "min_threshold_db": -42.0,
    "max_threshold_db": -6.0,
    "min_ratio": 1.5,
    "max_ratio": 4.0,
    "min_attack_ms": 1.0,
    "max_attack_ms": 50.0,
    "min_release_ms": 10.0,
    "max_release_ms": 250.0,
}


def sample_params(generator: torch.Generator, n: int, ranges: dict | None = None,
                  device=None) -> dict:
    """``n`` examples' parameters, each a (n,) fp32 tensor on ``device``."""
    r = {**DEFAULT_RANGES, **(ranges or {})}
    return {
        name: uniform(generator, r[f"min_{name}"], r[f"max_{name}"], n, device)
        for name in ("threshold_db", "ratio", "attack_ms", "release_ms")
    }


def ballistics_cte(time_ms: torch.Tensor, sample_rate) -> torch.Tensor:
    """JUCE BallisticsFilter coefficient; 0 below 1e-3 ms."""
    exp_factor = -2.0 * math.pi * 1000.0 / sample_rate
    return torch.where(time_ms < 1.0e-3, torch.zeros_like(time_ms),
                       torch.exp(exp_factor / time_ms))


def compressor_gain(env, threshold_db, ratio):
    thresh = 10.0 ** (threshold_db / 20.0)
    expo = 1.0 / ratio - 1.0
    # the +1e-30 stays inside the log, as in the JAX package
    return torch.where(env < thresh, torch.ones_like(env),
                       torch.exp(expo * torch.log(env / thresh + 1e-30)))


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def render(x: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """One example: ``x (..., T)`` with scalar ``params``."""
    p = {k: _as_tensor(v, x) for k, v in params.items()}
    flat = x.abs().reshape(-1, x.shape[-1]).contiguous()
    rows = flat.shape[0]
    cte_at = ballistics_cte(p["attack_ms"], sample_rate).expand(rows).contiguous()
    cte_rl = ballistics_cte(p["release_ms"], sample_rate).expand(rows).contiguous()
    env = envelope(flat, cte_at, cte_rl).reshape(x.shape)
    return (compressor_gain(env, p["threshold_db"], p["ratio"]) * x).to(x.dtype)


def render_batch(xb: torch.Tensor, params: dict, sample_rate) -> torch.Tensor:
    """Batched render: ``xb (B, C, T)``; ``params`` of (B,) values, one set
    per example, repeated over its C channels."""
    B, C, T = xb.shape
    p = {k: _as_tensor(v, xb) for k, v in params.items()}
    cte_at = ballistics_cte(p["attack_ms"], sample_rate)  # (B,)
    cte_rl = ballistics_cte(p["release_ms"], sample_rate)
    flat = xb.abs().reshape(B * C, T).contiguous()
    env = envelope(
        flat,
        cte_at.repeat_interleave(C).contiguous(),
        cte_rl.repeat_interleave(C).contiguous(),
    ).reshape(B, C, T)
    gain = compressor_gain(env, p["threshold_db"][:, None, None],
                           p["ratio"][:, None, None])
    return (gain * xb).to(xb.dtype)


def make(sample_rate, device=None, **overrides) -> RandomEffect:
    """The randomised compressor; its renderer is ``render_batch``."""
    ranges = {**DEFAULT_RANGES, **overrides}
    return RandomEffect("compressor", sample_rate, sample_params, render_batch,
                        ranges, device)
