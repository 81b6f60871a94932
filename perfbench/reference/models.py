"""The reference's models, built from a configuration file's entries."""

from __future__ import annotations

from torch import nn

from perfbench.reference.cnn14 import Cnn14
from perfbench.reference.dcunet import DCUNet
from perfbench.reference.hdemucs import HDemucs


def build(entry: dict) -> nn.Module:
    """A configuration's model entry (``kind`` and the program's factory
    keys) -> the reference module, in fp32 on the current default device."""
    kind = entry["kind"]
    if kind == "cnn14":
        if entry["sample_rate"] != entry["model_sample_rate"]:
            raise ValueError("the reference Cnn14 does not resample")
        return Cnn14(entry["num_classes"], entry["sample_rate"], entry["n_fft"],
                     entry["hop_length"], entry["n_mels"])
    if kind == "demucs":
        return HDemucs(sources=tuple(entry["sources"]), audio_channels=entry["audio_channels"],
                       channels=entry["channels"], nfft=entry["nfft"], depth=entry["depth"])
    if kind == "dcunet":
        if entry["fix_length_mode"] != "pad":
            raise ValueError("the reference DCUNet pads its frames only")
        return DCUNet(entry["architecture"], entry["stft_kernel_size"])
    raise ValueError(f"no reference model of kind {kind!r}")
