"""BatchNorm as ``flax.linen.BatchNorm`` trains it.

In train mode flax normalises with the batch's mean and biased variance
(``E[x^2] - E[x]^2``, floored at 0, in float32 whatever the input's
dtype) and updates the running statistics as ``0.9 * running + 0.1 *
batch`` with that same **biased** variance; torch's ``BatchNorm2d``
stores the unbiased one. Eval mode is torch's (the running statistics),
unchanged bit for bit, and so are the state-dict names, which the weight
bridges of ``compat/from_jax.py`` fill.

Under data parallelism a rank holds part of the batch. Inside
``parallel.split_batch`` of a split batch, the mean and ``E[x^2]`` are the
global batch's (the ranks' sums all-reduced over ``dp``, differentiably),
as the JAX package's are under GSPMD, so the output, the gradients and
the running statistics are one device's on the whole batch.

bf16-mixed training computes with bf16 copies of the parameters and
keeps the running statistics in fp32, which torch's batch norm takes
only with fp32 parameters: ``mixed_batch_norm`` gives it the weight and
bias in the statistics' dtype (torch's mixed-type kernel: bf16 in and
out, the statistics read and updated in fp32; where the dtypes agree the
cast does nothing and this is torch's forward). ``BatchNorm1d`` (UMX's,
whose running variance takes the unbiased batch variance as torch's
does) and ``BatchNorm2d``'s eval mode run through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.parallel.mesh import batch_means, current_split


def mixed_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """torch's forward of ``bn`` (affine, tracked statistics, a set
    ``momentum``) with the weight and bias cast to the running statistics'
    dtype (a differentiable cast, so the gradients reach the parameters as
    they came)."""
    dtype = bn.running_mean.dtype
    if bn.training:
        bn.num_batches_tracked.add_(1)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight.to(dtype),
                        bn.bias.to(dtype), bn.training, bn.momentum, bn.eps)


class BatchNorm1d(nn.BatchNorm1d):
    """torch's ``BatchNorm1d``, taking bf16 activations beside fp32 running
    statistics (``mixed_batch_norm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mixed_batch_norm(self, x)


def batch_statistics(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The train-mode (mean, biased variance) of ``xf`` (B, C, H, W) per
    channel, as flax takes them, differentiable; the global batch's under a
    split batch."""
    axes = (0, 2, 3)
    rows = current_split()
    if rows is None:
        mean, ex2 = xf.mean(axes), (xf * xf).mean(axes)
    else:
        mean, ex2 = batch_means([xf, xf * xf], axes, rows)
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


class BatchNorm2d(nn.BatchNorm2d):
    """``momentum`` is torch's (flax's 0.9 is 0.1 here); ``(B, C, H, W)``."""

    def track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running statistics moved toward the batch's ``batch_statistics``."""
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return mixed_batch_norm(self, x)
        xf = x.float()
        mean, var = batch_statistics(xf)
        self.track(mean, var)

        def bc(v):
            return v[None, :, None, None]

        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - bc(mean)) * bc(mul) + bc(self.bias.float())
        return y.to(x.dtype)
