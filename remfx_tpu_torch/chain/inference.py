"""RemFX chain inference — detect, then remove.

Counterpart of ``remfx_tpu/chain/inference.py`` (reference
``RemFXChainInference``, remfx/models.py:22-149): the classifier's
probabilities thresholded at 0.5 give the labels (or the caller gives
them: "oracle"; or every effect is switched on: "all"), then the removal
models run in the configured order over the whole batch, each stage
selecting its output per example:

    y = where(labels[:, idx] > 0.5, model_k(y), y)

When a model shortens its output (the TCN's valid convolutions), the
passthrough branch is causal-cropped so the batch stays rectangular.

Dispatch modes, as in the JAX package:

* ``"single"`` and ``"staged"``: the masked stages above, one after the
  other. The JAX package compiles the whole chain as one program
  ("single") or one program per stage ("staged"); PyTorch runs eagerly,
  so here the two names are one and the same loop.
* ``"regroup"``: one host readback of the five label counts per batch;
  then per stage, the model runs on a compact sub-batch of the rows whose
  label is on (``utils.regroup.bucket_size``), gathered and scattered
  back; the dense masked stage when most rows are on; and for a stage no
  row selects, only the passthrough's crop to the stage's output length,
  without running the model (``ModelWrapper.output_length``). It counts
  the rows its models run and, of those, the rows no label selected
  (``ChainInference.regroup_rows``, ``regroup_unselected``).

``forward`` / ``test_step`` / ``sample`` give the loss and the metrics
the system reports (SI-SDR and MR-STFT against the dry target).
"""

from __future__ import annotations

import random

import torch

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.losses import multi_resolution_stft_loss, removal_loss, si_sdr
from remfx_tpu_torch.utils.crop import causal_crop
from remfx_tpu_torch.utils.device import resolve_device
from remfx_tpu_torch.utils.regroup import bucket_size
from remfx_tpu_torch.utils.spans import span

DEFAULT_ORDER = (
    "RandomPedalboardDistortion",
    "RandomPedalboardCompressor",
    "RandomPedalboardReverb",
    "RandomPedalboardChorus",
    "RandomPedalboardDelay",
)

DISPATCH_MODES = ("single", "staged", "regroup")


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


def regrouped_stage(wrapper, idx: int, n: int, bucket: int):
    """The stage on a sub-batch of ``bucket`` rows: the ``n`` rows whose
    label is on, in their order (a stable sort of ``~mask``), padded with
    copies of the first; gather -> model -> causal-crop of the batch ->
    scatter of the ``n`` real rows."""

    def run(y, labels):
        mask = labels[:, idx] > 0.5
        order_ix = torch.argsort((~mask).to(torch.int32), stable=True)
        gi = order_ix[:bucket].clone()
        gi[n:] = gi[0]
        out = wrapper.sample(y.index_select(0, gi))
        if out.shape[-1] < y.shape[-1]:
            y = causal_crop(y, out.shape[-1])
        y = y.clone()
        y[gi[:n]] = out[:n]
        return y

    return run


def threshold_detect(net, threshold: float):
    """Classifier -> {0, 1} float labels (probs > threshold)."""

    @torch.no_grad()
    def run(x):
        return (net(x) > threshold).to(torch.float32)

    return run


class ChainInference:
    """models: {effect class name: ModelWrapper}; classifier: a Cnn14 or
    None. Every model is put in eval mode. On a CUDA batch, ``detect``,
    ``remove`` and ``run`` switch TF32 off for matmuls and cuDNN
    (``utils.device.resolve_device``), whoever built the models: a model
    made on the CPU and moved with ``.to("cuda")`` would otherwise run its
    convolutions in TF32, PyTorch's default for cuDNN.

    ``shuffle_effect_order`` makes ``test_step`` shuffle ``effect_order``
    in place before each batch, from ``random.Random(seed)``, as the
    reference does under its seeded run (its quirk 11).

    ``regroup_rows`` and ``regroup_unselected`` count, over the process,
    the rows the regroup dispatch ran its models on and those of them that
    no label selected (``utils/spans.py``)."""

    regroup_rows = 0
    regroup_unselected = 0

    def __init__(
        self,
        models: dict,
        sample_rate: int,
        effect_order=DEFAULT_ORDER,
        classifier=None,
        shuffle_effect_order: bool = False,
        use_all_effect_models: bool = False,
        threshold: float = 0.5,
        dispatch: str = "single",
        seed: int = 0,
    ):
        if dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch {dispatch!r} not in {DISPATCH_MODES}")
        self.models = {k: m.eval() for k, m in models.items()}
        self.sample_rate = sample_rate
        self.effect_order = tuple(effect_order)
        self.classifier = classifier.eval() if classifier is not None else None
        self.shuffle_effect_order = shuffle_effect_order
        self.use_all_effect_models = use_all_effect_models
        self.threshold = threshold
        self.dispatch = dispatch
        self._order_rng = random.Random(seed)

    def _stages(self, order):
        """(wrapper, label index) of each loaded slot, in ``order``."""
        for name in order:
            if name in self.models:
                yield self.models[name], ALL_EFFECTS.index(EFFECT_CLASS_NAMES[name])

    def detect(self, x: torch.Tensor) -> torch.Tensor:
        """Classifier labels for a batch: (B, 5) float {0, 1}."""
        if self.classifier is None:
            raise ValueError("no classifier configured")
        resolve_device(x.device)
        with span("chain.detect"):
            return threshold_detect(self.classifier, self.threshold)(x)

    def remove(self, x: torch.Tensor, labels: torch.Tensor, order=None):
        """Apply the masked removal stages for the given labels (no
        classifier call). -> (y, labels)."""
        order = tuple(order) if order is not None else self.effect_order
        resolve_device(x.device)
        y = x
        for wrapper, idx in self._stages(order):
            with span(f"chain.stage.{ALL_EFFECTS[idx]}"):
                y = masked_stage(wrapper, idx)(y, labels)
        return y, labels

    def _remove_regrouped(self, x: torch.Tensor, labels: torch.Tensor, order):
        with span("chain.counts"):
            counts = (labels > 0.5).sum(dim=0).tolist()  # the one host readback
        B = x.shape[0]
        y = x
        for wrapper, idx in self._stages(order):
            n = int(counts[idx])
            if n == 0:
                with span(f"chain.stage.{ALL_EFFECTS[idx]} n=0 b=skip"):
                    # the masked modes run, and crop for, every stage: keep
                    # their length without running the model
                    out_len = wrapper.output_length(y.shape[-1])
                    if out_len < y.shape[-1]:
                        y = causal_crop(y, out_len)
                continue
            bucket = bucket_size(n, B)
            dense = bucket is None or bucket >= B
            rows = B if dense else bucket
            ChainInference.regroup_rows += rows
            ChainInference.regroup_unselected += rows - n
            with span(f"chain.stage.{ALL_EFFECTS[idx]} n={n} b={'dense' if dense else rows}"):
                if dense:
                    y = masked_stage(wrapper, idx)(y, labels)
                else:
                    y = regrouped_stage(wrapper, idx, n, bucket)(y, labels)
        return y, labels

    def run(self, x: torch.Tensor, labels: torch.Tensor | None = None,
            order=None):
        """Labels from the classifier when there is one, else the given
        ones; all ones under ``use_all_effect_models``; then the removal
        stages in this chain's dispatch mode. -> (y, labels)."""
        order = tuple(order) if order is not None else self.effect_order
        resolve_device(x.device)
        if self.classifier is not None:
            labels = self.detect(x)
        if self.use_all_effect_models:
            labels = torch.ones(x.shape[0], len(ALL_EFFECTS), device=x.device)
        if labels is None:
            raise ValueError("no classifier and no labels given")
        if self.dispatch == "regroup":
            return self._remove_regrouped(x, labels, order)
        return self.remove(x, labels, order)

    def forward(self, batch, order=None, verbose: bool = False):
        """batch: (x, y, dry_labels, wet_labels) -> (loss, output), with
        the loss of ``losses.removal_loss``. A classifier's labels override
        ``wet_labels``."""
        x, y, _, wet_labels = batch
        order = tuple(order) if order is not None else self.effect_order
        output, labels = self.run(x, wet_labels, order)
        if verbose:
            on = labels[0].tolist()
            present = [name for name in order
                       if on[ALL_EFFECTS.index(EFFECT_CLASS_NAMES[name])] > 0.5]
            print("Detected effects:", present)
            print("Removing effects...")
        return removal_loss(output, y), output

    def test_step(self, batch) -> dict:
        """-> {test_loss, test_SISDR, test_STFT, Input_SISDR, Input_STFT}."""
        x, y, _, _ = batch
        order = list(self.effect_order)
        if self.shuffle_effect_order:
            self._order_rng.shuffle(order)  # in place, as the reference does
            self.effect_order = tuple(order)
        loss, output = self.forward(batch, order=order)
        yc = y
        if output.shape[-1] < y.shape[-1]:
            yc = causal_crop(y, output.shape[-1])
        return {
            "test_loss": loss,
            "test_SISDR": si_sdr(output, yc),
            "test_STFT": multi_resolution_stft_loss(output, yc),
            "Input_SISDR": si_sdr(x, y),
            "Input_STFT": multi_resolution_stft_loss(x, y),
        }

    def sample(self, batch) -> torch.Tensor:
        return self.forward(batch)[1]
