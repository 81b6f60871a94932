"""Parameter sampling for the port's effects.

Counterpart of the sampling helpers of ``remfx_tpu/fx/base.py``. The JAX
package draws one scalar per call from a ``jax.random`` key; the port
draws a batch of values from an explicit ``torch.Generator`` (on the
CPU, so that a seed gives the same values whatever the device), then
moves them to ``device``. The two generators give different numbers from
the same seed: parity tests pass explicit parameters to both packages.
"""

from __future__ import annotations

import torch


def uniform(generator: torch.Generator, lo: float, hi: float, n: int,
            device=None) -> torch.Tensor:
    """``n`` draws of U[lo, hi) — reference ``rand`` (remfx/effects.py:29-30)."""
    u = torch.rand(n, generator=generator, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(device)
