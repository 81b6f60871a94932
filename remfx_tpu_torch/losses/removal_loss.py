"""The removal models' training and test loss.

``loss = MR-STFT(output, target) + 100 * L1(output, target)``, with the
target causal-cropped (the reference's crop, which drops the final
sample) when the output is shorter. One definition for the wrapper's
``loss_and_output`` and the chain's ``forward``, as
``remfx_tpu/models/wrappers.py:65-83`` and
``remfx_tpu/chain/inference.py:302-304`` compute it.
"""

from __future__ import annotations

import torch

from remfx_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from remfx_tpu_torch.losses.time_loss import l1_loss
from remfx_tpu_torch.utils.crop import causal_crop

L1_WEIGHT = 100.0


def removal_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if output.shape[-1] < target.shape[-1]:
        target = causal_crop(target, output.shape[-1])
    return (multi_resolution_stft_loss(output, target)
            + L1_WEIGHT * l1_loss(output, target))
