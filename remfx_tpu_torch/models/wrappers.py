"""Removal-model wrapper: the loss and ``sample`` contract.

Counterpart of ``remfx_tpu/models/wrappers.py:ModelWrapper`` (reference
remfx/models.py:259-390). ``forward(x)`` is the model's output, as
``nn.Module`` has it; the JAX wrapper's ``forward((x, target))`` is
``loss_and_output`` here. With ``residual``, the wrapper adds the input
back (``x[..., :T_out]``), the identity-start mode of
``make_demucs(identity_init=True)``. A bf16 call on the CPU runs under
``utils/device.py:cpu_bf16_convolutions``. The JAX wrapper's
``takes_train_flag`` is ``train()`` / ``eval()`` here. ``forward`` is the
span ``model.<name>`` and the loss the span ``loss`` (``utils/spans.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from remfx_tpu_torch.losses import removal_loss
from remfx_tpu_torch.utils.device import cpu_bf16_convolutions
from remfx_tpu_torch.utils.spans import span


class ModelWrapper(nn.Module):
    def __init__(self, module: nn.Module, name: str = "model",
                 residual: bool = False):
        super().__init__()
        self.module = module
        self.name = name
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(f"model.{self.name}"):
            with cpu_bf16_convolutions(x):  # bf16 on the CPU: off oneDNN's faults
                out = self.module(x)
            if self.residual:
                out = out + x[..., : out.shape[-1]]
            return out

    def loss_and_output(self, batch):
        """``(x, target) -> (loss, output)``: the JAX wrapper's ``forward``
        (``remfx_tpu/models/wrappers.py:65-83``), with the loss of
        ``losses.removal_loss``. In train mode the target is cast to the
        output's dtype."""
        x, target = batch
        output = self(x)
        if self.training and output.dtype != target.dtype:
            # bf16-mixed: the loss takes the target in the output's dtype
            # (remfx_tpu/models/wrappers.py:71-79)
            target = target.to(output.dtype)
        with span("loss"):
            return removal_loss(output, target), output

    @torch.no_grad()
    def sample(self, x: torch.Tensor) -> torch.Tensor:
        """Inference: (B, C, T) -> (B, C, T') removed audio."""
        return self(x)

    def output_length(self, length: int) -> int:
        """T' that ``sample`` gives for ``length`` samples in, without
        running the model (the JAX package asks ``jax.eval_shape``)."""
        return self.module.output_length(length)
