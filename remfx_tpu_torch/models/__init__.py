"""Model factories of the port (``remfx_tpu/models/__init__.py``).

Each factory builds its model on ``device`` (the card unless the caller
names another) in eval mode, with PyTorch's default initialisation;
weights from the JAX package come in through ``compat.from_jax``.
"""

from __future__ import annotations

from remfx_tpu_torch.models.cnn14 import Cnn14
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.utils.device import resolve_device


def make_cnn14(
    num_classes=5,
    sample_rate=48000,
    model_sample_rate=48000,
    n_fft=2048,
    hop_length=512,
    n_mels=128,
    device=None,
    **_ignored,
) -> Cnn14:
    net = Cnn14(
        num_classes=num_classes,
        sample_rate=sample_rate,
        model_sample_rate=model_sample_rate,
        n_fft=n_fft,
        hop_length=hop_length,
        n_mels=n_mels,
    )
    return net.to(resolve_device(device)).eval()


def make_demucs(
    sample_rate=48000,
    sources=("mixture",),
    audio_channels=1,
    nfft=4096,
    channels=48,
    depth=6,
    identity_init=False,
    device=None,
    **_ignored,
) -> ModelWrapper:
    # identity_init: zero the final transposed convs and add the input
    # back in the wrapper, so the model starts as an exact passthrough
    module = HDemucs(
        sources=tuple(sources),
        audio_channels=audio_channels,
        channels=channels,
        nfft=nfft,
        depth=depth,
        zero_final=bool(identity_init),
    )
    wrapper = ModelWrapper(module, name="demucs", residual=bool(identity_init))
    return wrapper.to(resolve_device(device)).eval()
