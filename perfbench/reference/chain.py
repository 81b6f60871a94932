"""The reference's detect -> remove chain: the masked stages of the RemFX
reference (``RemFXChainInference``, remfx/models.py:22-149), in order,

    y = where(labels[:, effect] > 0.5, model(y), y)

with the passthrough causal-cropped (``x[..., L-1-n : L-1]``) where a model
shortens its output. The model runs only on the rows whose label is on,
in blocks of rows, which gives the same rows as the masked form.
"""

from __future__ import annotations

import torch


def causal_crop(x: torch.Tensor, length: int) -> torch.Tensor:
    stop = x.shape[-1] - 1
    return x[..., stop - length:stop]


@torch.no_grad()
def in_blocks(model, x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([model(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


@torch.no_grad()
def remove(stages, x: torch.Tensor, labels: torch.Tensor, rows: int) -> torch.Tensor:
    """stages: [(model, label column)] in order; x (B, 1, T); labels (B, E)."""
    y = x
    for model, column in stages:
        sel = torch.nonzero(labels[:, column] > 0.5)[:, 0]
        if sel.numel() == 0:
            continue
        out = in_blocks(model, y[sel], rows)
        if out.shape[-1] < y.shape[-1]:
            y = causal_crop(y, out.shape[-1])
        y = y.clone()
        y[sel] = out
    return y
