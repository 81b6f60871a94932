"""Losses of the port (``remfx_tpu/losses``)."""

from remfx_tpu_torch.losses.stft_loss import (
    MultiResolutionSTFTLoss,
    STFTLoss,
    multi_resolution_stft_loss,
)
from remfx_tpu_torch.losses.removal_loss import removal_loss
from remfx_tpu_torch.losses.time_loss import l1_loss, si_sdr, sisdr_loss

__all__ = [
    "MultiResolutionSTFTLoss",
    "STFTLoss",
    "multi_resolution_stft_loss",
    "l1_loss",
    "removal_loss",
    "si_sdr",
    "sisdr_loss",
]
