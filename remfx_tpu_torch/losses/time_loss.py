"""Time-domain losses: SI-SDR and L1.

Counterpart of ``remfx_tpu/losses/time_loss.py`` (``auraloss.time.
SISDRLoss`` defaults: zero_mean=True, eps=1e-8). The reference negates
the loss when it logs it, so that higher is better; both conventions are
here.
"""

from __future__ import annotations

import torch


def sisdr_loss(x: torch.Tensor, y: torch.Tensor, zero_mean: bool = True,
               eps: float = 1e-8) -> torch.Tensor:
    """Negative SI-SDR averaged over all leading dims (auraloss
    SISDRLoss). ``x`` = estimate, ``y`` = target, shape (..., T)."""
    if zero_mean:
        x = x - x.mean(dim=-1, keepdim=True)
        y = y - y.mean(dim=-1, keepdim=True)
    alpha = (x * y).sum(dim=-1) / ((y ** 2).sum(dim=-1) + eps)
    target = y * alpha[..., None]
    res = x - target
    ratio = (target ** 2).sum(dim=-1) / ((res ** 2).sum(dim=-1) + eps)
    return -(10.0 * torch.log10(ratio + eps)).mean()


def si_sdr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SI-SDR in dB, higher is better (the logged metric convention)."""
    return -sisdr_loss(x, y)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, reduced in fp32 whatever the compute dtype."""
    return (x.float() - y.float()).abs().mean()
