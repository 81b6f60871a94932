"""Frozen-embedding classifiers (PANNs / Wav2CLIP / VGGish / wav2vec2).

Counterpart of ``remfx_tpu/models/embedding_classifiers.py``; parity target
reference remfx/classifier.py:16-128: a frozen HEAR embedding model and a
trainable three-layer MLP head (embed_dim -> 256 -> 256 -> num_classes).

The embedding is a plain callable ``embed_fn((B, T) audio at the embedder's
rate) -> (B, D)``, held outside the module's parameters as the JAX module
holds it outside its variables: the trainable parameters, the optimizer's
state and a checkpoint are the head's only. It runs under ``no_grad``
(JAX's ``stop_gradient``), and the PANNs trunk stays in eval mode whatever
mode the classifier is in. ``panns`` is self-contained: the in-repo Cnn14
trunk at 32 kHz is the reference's ``panns_hear`` scene embedder, with
random weights from a fixed seed unless a state dict is given. The other
three need external HEAR checkpoints, which are downloads; without them
they raise rather than substitute another network. ``.to(device)`` moves
the head only: build the classifier on its device.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.cnn14 import Cnn14
from remfx_tpu_torch.ops.resample import resample
from remfx_tpu_torch.utils.device import cpu_bf16_convolutions, resolve_device

EMBED_DIMS = {
    "panns": 2048,  # PANNs HEAR scene embeddings @32k
    "wav2clip": 512,  # @16k
    "vggish": 128,  # @16k
    "wav2vec2": 1024,  # @16k
}
EMBED_RATES = {"panns": 32000, "wav2clip": 16000, "vggish": 16000, "wav2vec2": 16000}


class ProjHead(nn.Module):
    """The reference's trainable projection MLP."""

    def __init__(self, embed_dim: int, num_classes: int, hidden_dim: int = 256):
        super().__init__()
        self.fc0 = nn.Linear(embed_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, num_classes)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc0(emb))
        h = F.relu(self.fc1(h))
        return self.fc2(h)  # logits (the CE path)


class EmbeddingClassifier(nn.Module):
    """Frozen ``embed_fn`` + trainable head -> logits ``(B, num_classes)``:
    the reference's non-Cnn14 classifiers return logits for
    CrossEntropyLoss (quirk #9) and sigmoid-F1 metrics."""

    def __init__(self, num_classes: int, sample_rate: float, embed_fn: Callable,
                 embed_dim: int, embed_rate: int = 16000, hidden_dim: int = 256):
        super().__init__()
        self.sample_rate = sample_rate
        self.embed_fn = embed_fn
        self.embed_rate = embed_rate
        self.proj = ProjHead(embed_dim, num_classes, hidden_dim)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``x (B, C, T)`` or ``(B, T)``; ``generator`` is taken for the
        classifier task's signature and not read (no random draws here). A
        bf16 call on the CPU runs under ``cpu_bf16_convolutions``."""
        with cpu_bf16_convolutions(x):
            if x.dim() == 3:
                # mono-sum channels like every other audio entry point
                x = x.sum(dim=1)
            if int(self.sample_rate) != int(self.embed_rate):
                x = resample(x, int(self.sample_rate), int(self.embed_rate))
            with torch.no_grad():
                emb = self.embed_fn(x)
            return self.proj(emb)


class PannsEmbedding:
    """The frozen PANNs embedder: ``trunk.embed`` of a Cnn14 at 32 kHz, in
    eval mode, its parameters frozen."""

    def __init__(self, trunk: Cnn14):
        self.trunk = trunk.eval().requires_grad_(False)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk.embed(x)


def make_panns_embed_fn(state_dict=None, seed: int = 0, device=None) -> PannsEmbedding:
    """The Cnn14 trunk at 32 kHz as the PANNs embedder. ``state_dict``: a
    converted PANNs or Cnn14 checkpoint; without one, the trunk has torch's
    default initialisation under ``seed``, leaving the process's random
    state as it was (the head still trains end to end on untrained
    embeddings, as in the JAX package)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = Cnn14(num_classes=5, sample_rate=32000, model_sample_rate=32000)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    return PannsEmbedding(net.to(resolve_device(device)))


def make_embedding_classifier(
    kind: str,
    num_classes: int,
    sample_rate: float,
    embed_fn: Callable | None = None,
    embed_state_dict=None,
    hidden_dim: int = 256,
    device=None,
) -> EmbeddingClassifier:
    """A PANNs / Wav2CLIP / VGGish / wav2vec2-style classifier on ``device``
    (``None``: the card); ``embed_fn`` returns the kind's width
    (``EMBED_DIMS``)."""
    if embed_fn is None and kind == "panns":
        embed_fn = make_panns_embed_fn(embed_state_dict, device=device)
    if embed_fn is None:
        raise RuntimeError(
            f"The {kind} classifier needs frozen embedding weights "
            "(external HEAR checkpoints, see reference remfx/classifier.py). "
            "Convert them with compat/ tools and pass embed_fn=...")
    return EmbeddingClassifier(
        num_classes=num_classes,
        sample_rate=sample_rate,
        embed_fn=embed_fn,
        embed_dim=EMBED_DIMS[kind],
        embed_rate=EMBED_RATES.get(kind, 16000),
        hidden_dim=hidden_dim,
    ).to(resolve_device(device))
