"""Pipeline-parallel chain inference: one stage per device.

Counterpart of ``remfx_tpu/chain/pipeline.py``. The detect -> remove
chain is a fixed sequence of models (the classifier, then up to five
removal models), so it is a pipeline: each stage's module is parked on its
own device once, and window batches flow from stage to stage by
device-to-device copies. PyTorch returns from a CUDA launch before the
card has run it, and the copies are ``non_blocking``, so the host submits
every (window, stage) ahead and stage k of window i runs while stage k-1
works on window i+1 on another card, as the JAX package's async dispatch
does: W windows over S stages take about W + S - 1 stage times instead of
W x S on one card.

The stages are ``chain/inference.py``'s ``threshold_detect`` and
``masked_stage``, so each window's result equals ``ChainInference.run``
(in its "single" dispatch) on the same device type bit for bit.
"""

from __future__ import annotations

import copy

import torch

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.inference import masked_stage, threshold_detect
from remfx_tpu_torch.utils.device import resolve_device


def _park(module, device):
    """``module`` on ``device``: itself when it is there, else a copy (the
    chain's own modules stay where they are)."""
    if next(module.parameters()).device == device:
        return module
    return copy.deepcopy(module).to(device).eval()


class PipelineChain:
    """Stage-per-device executor over a ``ChainInference``'s models.

    ``devices``: the devices of the stages, assigned round-robin, the
    classifier first when the chain has one; every card by default (no
    card raises: pass ``devices=["cpu"]`` for the host).
    """

    def __init__(self, chain, devices=None):
        self.chain = chain
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not devices:
                resolve_device(None)  # raises: no card
        devices = [resolve_device(d) for d in devices]
        self.order = tuple(n for n in chain.effect_order if n in chain.models)
        stages = (["classifier"] if chain.classifier is not None else []) + list(self.order)
        self.stage_device = {name: devices[i % len(devices)] for i, name in enumerate(stages)}
        self._stages = {}
        if chain.classifier is not None:
            net = _park(chain.classifier, self.stage_device["classifier"])
            self._stages["classifier"] = threshold_detect(net, chain.threshold)
        for name in self.order:
            wrapper = _park(chain.models[name], self.stage_device[name])
            idx = ALL_EFFECTS.index(EFFECT_CLASS_NAMES[name])
            self._stages[name] = masked_stage(wrapper, idx)

    @torch.no_grad()
    def __call__(self, windows, labels=None):
        """windows: an iterable of (B, C, T) batches; labels: (B, 5) of every
        window, or None to detect with the chain's classifier (ones without
        one). -> [(y, labels)] in input order, each on its last stage's
        device; nothing waits for the card until the caller reads one."""
        outs = []
        for x in windows:
            lab = labels
            if lab is None:
                if self.chain.classifier is None:
                    lab = torch.ones(x.shape[0], len(ALL_EFFECTS), device=x.device)
                else:
                    dev = self.stage_device["classifier"]
                    lab = self._stages["classifier"](x.to(dev, non_blocking=True))
            if self.chain.use_all_effect_models:
                lab = torch.ones_like(lab)
            y = x
            for name in self.order:
                dev = self.stage_device[name]
                y = self._stages[name](y.to(dev, non_blocking=True),
                                       lab.to(dev, non_blocking=True))
            outs.append((y, lab))
        return outs
