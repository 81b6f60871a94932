"""Seeded weights: a state dict drawn from the seed on the device, in a few
large calls, from the reference module's own structure.

Two rules, as each model's entry in the configuration states (``init``):

* ``torch``, PyTorch's default scales, where a training run starts: a
  convolution's or linear layer's weight and bias ~ U(-b, b) with b = 1 /
  sqrt(fan_in), fan_in = the weight's ``shape[1] * prod(kernel)``.
* ``he``, for a model that serves in place of trained weights: the
  weights ~ U(-b, b) with b = sqrt(6 / fan_in), which keeps a signal's
  scale through ReLU layers as trained weights with their norms do (under
  ``torch`` Cnn14's twelve convolutions shrink its input below fp32's
  resolution, and its output is the same for every input); the biases as
  under ``torch``.

Under both, an LSTM's every weight and bias ~ U(-b, b) with b = 1 /
sqrt(hidden), and an embedding ~ N(0, 1) / 10 (HDemucs' ScaledEmbedding
divides its init by its scale, 10). Every other parameter keeps the
constant its constructor gives (norms' 1 and 0, LayerScale's 1e-4), and
buffers keep theirs (running statistics, windows, filterbanks); a
parameter that is not constant is refused, so that nothing depends on
torch's global generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_AFFINE = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear)
EMBEDDING_STD = 0.1


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for ``stream`` under ``seed``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (stream + 1)) % 2**63


def _plan(module: nn.Module, init: str):
    """[(parameter, 'uniform' | 'normal', scale)] of the drawn leaves."""
    if init not in ("torch", "he"):
        raise ValueError(f"init {init!r}: 'torch' or 'he'")
    plan, kept = [], set()
    for m in module.modules():
        own = list(m.named_parameters(recurse=False))
        if isinstance(m, _AFFINE):
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            weight = math.sqrt(6.0 / fan_in) if init == "he" else bound
            plan += [(p, "uniform", weight if name == "weight" else bound) for name, p in own]
        elif isinstance(m, nn.LSTM):
            plan += [(p, "uniform", 1.0 / math.sqrt(m.hidden_size)) for _, p in own]
        elif isinstance(m, nn.Embedding):
            plan += [(p, "normal", EMBEDDING_STD) for _, p in own]
        else:
            kept.update(id(p) for _, p in own)
    return plan, kept


@torch.no_grad()
def seed_module_(module: nn.Module, seed: int, init: str) -> dict:
    """Fill ``module``'s drawn leaves from ``seed`` (a generator on the
    module's device) by the rule ``init`` and return its state dict."""
    plan, kept = _plan(module, init)
    for name, p in module.named_parameters():
        if id(p) in kept and bool((p != p.flatten()[0]).any()):
            raise ValueError(f"{name} is neither drawn nor constant")
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for kind in ("uniform", "normal"):
        leaves = [(p, s) for p, k, s in plan if k == kind]
        total = sum(p.numel() for p, _ in leaves)
        if not total:
            continue
        if kind == "uniform":
            flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
        else:
            flat = torch.randn(total, generator=gen, device=device)
        offset = 0
        for p, scale in leaves:
            p.copy_(flat[offset:offset + p.numel()].view_as(p) * scale)
            offset += p.numel()
    return module.state_dict()
