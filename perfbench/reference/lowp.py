"""The reference computed in fp8, the control of a bf16 configuration.

Every convolution, transposed convolution, linear layer and LSTM takes its
weights and its input rounded to float8 e4m3 under a per-tensor scale (the
tensor's largest magnitude onto e4m3's largest finite value, 448), and
sums in fp32: what an fp8 path of the program would compute. Used by the
benchmark's control runs and tests, never by a measured run.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0
_QUANTIZED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear, nn.LSTM)


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _round_input(module, args):
    return tuple(to_fp8(a) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


@torch.no_grad()
def fp8_(model: nn.Module) -> nn.Module:
    """Round ``model``'s weights to fp8 in place and its layers' inputs on
    every call."""
    for m in model.modules():
        if isinstance(m, _QUANTIZED):
            for p in m.parameters(recurse=False):
                p.copy_(to_fp8(p))
            m.register_forward_pre_hook(_round_input)
    return model
