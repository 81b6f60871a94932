"""Removal-model wrapper: the ``sample`` contract and the residual skip.

Counterpart of ``remfx_tpu/models/wrappers.py:ModelWrapper``. With
``residual``, the wrapper adds the input back (``x[..., :T_out]``), the
identity-start mode of ``make_demucs(identity_init=True)``. The JAX
wrapper's ``forward((x, target)) -> loss`` (MR-STFT + 100 * L1) waits for
the losses slice; here ``forward(x)`` is the model's output.
"""

from __future__ import annotations

import torch
from torch import nn


class ModelWrapper(nn.Module):
    def __init__(self, module: nn.Module, name: str = "model",
                 residual: bool = False):
        super().__init__()
        self.module = module
        self.name = name
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.module(x)
        if self.residual:
            out = out + x[..., : out.shape[-1]]
        return out

    @torch.no_grad()
    def sample(self, x: torch.Tensor) -> torch.Tensor:
        """Inference: (B, C, T) -> (B, C, T') removed audio."""
        return self(x)
