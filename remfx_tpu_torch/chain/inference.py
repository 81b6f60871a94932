"""RemFX chain inference — detect, then remove.

Counterpart of ``remfx_tpu/chain/inference.py`` (reference
``RemFXChainInference``, remfx/models.py:22-149): the classifier's
probabilities thresholded at 0.5 give the labels (or the caller gives
them: "oracle"; or every effect is switched on: "all"), then the removal
models run in the configured order over the whole batch, each stage
selecting its output per example:

    y = where(labels[:, idx] > 0.5, model_k(y), y)

When a model shortens its output, the passthrough branch is
causal-cropped so the batch stays rectangular.

Ported so far: ``masked_stage``, ``threshold_detect``, ``detect``,
``remove`` and ``run`` (the staged dispatch: classifier or given labels,
``use_all_effect_models``, then ``remove``). The JAX package's
``forward``/``test_step`` (they need the MR-STFT losses) and its
``regroup`` dispatch wait for later slices.
"""

from __future__ import annotations

import torch

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.utils.crop import causal_crop
from remfx_tpu_torch.utils.device import resolve_device

DEFAULT_ORDER = (
    "RandomPedalboardDistortion",
    "RandomPedalboardCompressor",
    "RandomPedalboardReverb",
    "RandomPedalboardChorus",
    "RandomPedalboardDelay",
)


def masked_stage(wrapper, idx: int):
    """Apply ``wrapper`` where ``labels[:, idx] > 0.5``; causal-crop the
    passthrough branch when the model shortens its output."""

    def run(y, labels):
        mask = labels[:, idx] > 0.5
        out = wrapper.sample(y)
        if out.shape[-1] < y.shape[-1]:
            y = causal_crop(y, out.shape[-1])
        return torch.where(mask[:, None, None], out, y)

    return run


def threshold_detect(net, threshold: float):
    """Classifier -> {0, 1} float labels (probs > threshold)."""

    @torch.no_grad()
    def run(x):
        return (net(x) > threshold).to(torch.float32)

    return run


class ChainInference:
    """models: {effect class name: ModelWrapper}; classifier: a Cnn14 or
    None. Every model is put in eval mode. On a CUDA batch, ``detect`` and
    ``remove`` switch TF32 off for matmuls and cuDNN
    (``utils.device.resolve_device``), whoever built the models: a model
    made on the CPU and moved with ``.to("cuda")`` would otherwise run its
    convolutions in TF32, PyTorch's default for cuDNN."""

    def __init__(
        self,
        models: dict,
        sample_rate: int,
        effect_order=DEFAULT_ORDER,
        classifier=None,
        use_all_effect_models: bool = False,
        threshold: float = 0.5,
    ):
        self.models = {k: m.eval() for k, m in models.items()}
        self.sample_rate = sample_rate
        self.effect_order = tuple(effect_order)
        self.classifier = classifier.eval() if classifier is not None else None
        self.use_all_effect_models = use_all_effect_models
        self.threshold = threshold

    def detect(self, x: torch.Tensor) -> torch.Tensor:
        """Classifier labels for a batch: (B, 5) float {0, 1}."""
        if self.classifier is None:
            raise ValueError("no classifier configured")
        resolve_device(x.device)
        return threshold_detect(self.classifier, self.threshold)(x)

    def remove(self, x: torch.Tensor, labels: torch.Tensor, order=None):
        """Apply the removal stages for the given labels (no classifier
        call). -> (y, labels)."""
        order = tuple(order) if order is not None else self.effect_order
        resolve_device(x.device)
        y = x
        for name in order:
            if name not in self.models:
                continue
            idx = ALL_EFFECTS.index(EFFECT_CLASS_NAMES[name])
            y = masked_stage(self.models[name], idx)(y, labels)
        return y, labels

    def run(self, x: torch.Tensor, labels: torch.Tensor | None = None,
            order=None):
        """Labels from the classifier when there is one, else the given
        ones; all ones under ``use_all_effect_models``; then ``remove``.
        -> (y, labels)."""
        if self.classifier is not None:
            labels = self.detect(x)
        if self.use_all_effect_models:
            labels = torch.ones(x.shape[0], len(ALL_EFFECTS), device=x.device)
        if labels is None:
            raise ValueError("no classifier and no labels given")
        return self.remove(x, labels, order)
