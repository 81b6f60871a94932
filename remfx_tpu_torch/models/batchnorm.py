"""BatchNorm as ``flax.linen.BatchNorm`` trains it.

In train mode flax normalises with the batch's mean and biased variance
(``E[x^2] - E[x]^2``, floored at 0, in float32 whatever the input's
dtype) and updates the running statistics as ``0.9 * running + 0.1 *
batch`` with that same **biased** variance; torch's ``BatchNorm2d``
stores the unbiased one. Eval mode is torch's (the running statistics),
unchanged bit for bit, and so are the state-dict names, which the weight
bridges of ``compat/from_jax.py`` fill.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``momentum`` is torch's (flax's 0.9 is 0.1 here); ``(B, C, H, W)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        axes = (0, 2, 3)
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked += 1

        def bc(v):
            return v[None, :, None, None]

        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - bc(mean)) * bc(mul) + bc(self.bias.float())
        return y.to(x.dtype)
