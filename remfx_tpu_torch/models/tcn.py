"""Dilated temporal convolutional network (TCN) removal backbone.

Counterpart of ``remfx_tpu/models/tcn.py`` (reference ``remfx/tcn.py``,
micro-tcn): ``nblocks`` dilated Conv1d blocks (valid padding, dilation
``dilation_growth ** (n % stack_size)``) with a per-channel PReLU and a
bias-free 1x1 residual cropped to the block's output, then a 1x1 conv
and ``tanh``. Channel-first ``(B, C, T)`` throughout; the output is
``T - receptive_field + 1`` samples long.

State-dict names are the reference's (``process_blocks.{n}.conv1``,
``.relu``, ``.res`` and ``output``), so ``compat.from_jax.tcn_state_dict``
is the plain inverse of ``remfx_tpu/compat/torch_import.py:convert_tcn``.

``remat`` is the JAX package's ``nn.remat`` of each block
(``remfx_tpu/models/tcn.py:73-81``): in train mode each block runs under
``torch.utils.checkpoint``, so the backward pass keeps only the blocks'
inputs and recomputes the rest (at 16 x 256 x 262144, one fp32 block
activation is 4.3 GB). The values are the same; eval is unchanged.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from remfx_tpu_torch.utils.crop import causal_crop, center_crop


class PReLU(nn.Module):
    """Per-channel PReLU, ``where(x >= 0, x, a * x)`` over ``(B, C, T)``."""

    def __init__(self, features: int, init_slope: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), init_slope))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight[:, None] * x)


class TCNBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dilation: int = 1, crop_fn=causal_crop):
        super().__init__()
        self.conv1 = nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation)
        self.relu = PReLU(out_ch)
        self.res = nn.Conv1d(in_ch, out_ch, 1, bias=False)
        self.crop_fn = crop_fn

    def forward(self, x):
        y = self.relu(self.conv1(x))
        return y + self.crop_fn(self.res(x), y.shape[-1])


class TCN(nn.Module):
    def __init__(self, ninputs: int = 1, noutputs: int = 1, nblocks: int = 4,
                 channel_growth: int = 0, channel_width: int = 32,
                 kernel_size: int = 13, stack_size: int = 10,
                 dilation_growth: int = 10, causal: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.kernel_size = kernel_size
        self.nblocks = nblocks
        self.stack_size = stack_size
        self.dilation_growth = dilation_growth
        crop_fn = causal_crop if causal else center_crop
        blocks = []
        out_ch = -1
        for n in range(nblocks):
            in_ch = out_ch if n > 0 else ninputs
            out_ch = (in_ch * channel_growth if channel_growth > 1
                      else channel_width)
            dilation = dilation_growth ** (n % stack_size)
            blocks.append(TCNBlock(in_ch, out_ch, kernel_size, dilation,
                                   crop_fn))
        self.process_blocks = nn.ModuleList(blocks)
        self.output = nn.Conv1d(out_ch, noutputs, 1)

    def forward(self, x):
        """x: (B, C_in, T) -> (B, C_out, T - receptive_field + 1)."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.process_blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return torch.tanh(self.output(x))

    def compute_receptive_field(self) -> int:
        rf = self.kernel_size
        for n in range(1, self.nblocks):
            dilation = self.dilation_growth ** (n % self.stack_size)
            rf = rf + (self.kernel_size - 1) * dilation
        return rf

    def output_length(self, length: int) -> int:
        """Samples out for ``length`` in (valid convolutions)."""
        return length - self.compute_receptive_field() + 1

    def time_reach(self) -> tuple[int, int]:
        """Input samples before and after its own that an output sample
        reads: output ``j`` reads input ``[j, j + rf - 1]``, with the centre
        and the causal crop alike (``parallel/sequence.py``)."""
        return 0, self.compute_receptive_field() - 1

    def time_alignment(self) -> int:
        """The stride of the grid a window must start on: every sample."""
        return 1
