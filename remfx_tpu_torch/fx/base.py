"""Parameter sampling and the randomised-effect wrapper.

Counterpart of ``remfx_tpu/fx/base.py``. The JAX package draws one scalar
per call from a ``jax.random`` key and renders one example under
``vmap``; the port draws a batch of values from an explicit
``torch.Generator`` (on the CPU, so that a seed gives the same values
whatever the device), moves them to ``device``, and renders a whole batch
``(B, C, T)`` with parameters of leading dimension B. The two generators
give different numbers from the same seed: parity tests pass explicit
parameters to both packages.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from remfx_tpu_torch.utils.device import resolve_device


def uniform(generator: torch.Generator, lo: float, hi: float, n: int,
            device=None) -> torch.Tensor:
    """``n`` draws of U[lo, hi) — reference ``rand`` (remfx/effects.py:29-30)."""
    u = torch.rand(n, generator=generator, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(device)


def loguniform(generator: torch.Generator, lo: float, hi: float, n: int,
               device=None) -> torch.Tensor:
    """``n`` log-uniform draws — reference ``loguniform`` (scipy.stats)."""
    u = torch.rand(n, generator=generator, dtype=torch.float32)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))).to(device)


def randint(generator: torch.Generator, lo: int, hi: int, n: int,
            device=None) -> torch.Tensor:
    """``n`` uniform integers in [lo, hi], inclusive — reference ``randint``."""
    return torch.randint(int(lo), int(hi) + 1, (n,), generator=generator).to(device)


class RandomEffect:
    """A randomised effect: draws fresh parameters per example, then renders.

    ``sampler(generator, n, ranges, device)`` -> a dict of ``(n, ...)``
    tensors; ``render_fn(xb, params, sample_rate)`` renders a batch
    ``xb (B, C, T)`` with ``(B, ...)`` parameters, on ``xb``'s device.
    (The JAX class also takes an optional natively batched renderer
    beside its per-example one; here every renderer is batched.)
    ``ranges`` holds the min/max config (cfg/effects/all.yaml surface).
    Parameters land on ``device``: ``None`` is the card.
    """

    def __init__(self, name: str, sample_rate: float, sampler: Callable,
                 render_fn: Callable, ranges: dict, device=None):
        self.name = name
        self.sample_rate = sample_rate
        self.sampler = sampler
        self.render_fn = render_fn
        self.ranges = dict(ranges)
        self.device = resolve_device(device)

    def sample_params(self, generator: torch.Generator, n: int) -> dict:
        return self.sampler(generator, n, self.ranges, self.device)

    def render_batch(self, xb: torch.Tensor, params: dict) -> torch.Tensor:
        return self.render_fn(xb, params, self.sample_rate)

    def render(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        """One example ``x (C, T)``: the batch render at B = 1, with scalar
        (or per-example) parameters."""
        p = {k: torch.as_tensor(v, device=x.device)[None] for k, v in params.items()}
        return self.render_fn(x[None], p, self.sample_rate)[0]

    def __call__(self, generator: torch.Generator, xb: torch.Tensor) -> torch.Tensor:
        """Draw parameters for every example of ``xb`` and render — the
        reference's ``forward``."""
        return self.render_batch(xb, self.sample_params(generator, xb.shape[0]))
