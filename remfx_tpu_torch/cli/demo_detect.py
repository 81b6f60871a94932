"""Detect -> remove on one file with trained weights only.

Counterpart of ``scripts/demo_detect.py`` (the reference's north-star
flow, scripts/remfx_detect.sh): the chain of the config, its checkpoint
map pruned to the vendored trained removers that exist and its
classifier pointed at the trained Cnn14, so that no random weights touch
the audio. The classifier decides which effects are present; the chain
removes the detected effects that have a trained remover. Prints one
JSON report: the detected effects, the classifier's probabilities, the
effects removed and, given a target, the SI-SDR before and after.

    python -m remfx_tpu_torch.cli.demo_detect +exp=remfx_detect \
        +audio_input=in.wav [+target=target.wav] [+output_path=out.wav]

Paths are relative to the working directory, as in the JAX script.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.data.wav import read_wav, write_wav
from remfx_tpu_torch.losses import si_sdr
from remfx_tpu_torch.train.loop import device_of
from remfx_tpu_torch.utils.crop import causal_crop

# first existing dir wins per effect: prefer the strongest vendored
# remover (the round-4 DCUNet reverb_aug supersedes the +0.2 dB UMX)
TRAINED_PREFS = {
    "RandomPedalboardDistortion": ["ckpts/tcn_distortion_aug"],
    "RandomPedalboardCompressor": ["ckpts/demucs_compressor_aug_r5"],
    "RandomPedalboardReverb": ["ckpts/dcunet_reverb_aug_r5",
                               "ckpts/dcunet_reverb_aug_r4",
                               "ckpts/umx_reverb_synth"],
    "RandomPedalboardChorus": ["ckpts/dcunet_chorus_aug_r5"],
    "RandomPedalboardDelay": ["ckpts/dcunet_delay_aug_r5"],
}
CLASSIFIER_PREFS = ("ckpts/classifier_cnn14_r5", "ckpts/classifier_cnn14_r4",
                    "ckpts/classifier_cnn14")


def trained_cfg(cfg: dict) -> dict:
    """``cfg`` with its ckpt map pruned to the vendored removers that
    exist and the classifier pointed at the trained Cnn14 (in place)."""
    trained = {k: next((p for p in prefs if Path(p).is_dir()), prefs[-1])
               for k, prefs in TRAINED_PREFS.items()}
    cfg["ckpts"] = {k: {"model": "tcn", "ckpt_path": v}
                    for k, v in trained.items() if Path(v).is_dir()}
    cfg["classifier_ckpt"] = next(
        (p for p in CLASSIFIER_PREFS if Path(p).is_dir()), CLASSIFIER_PREFS[-1])
    return cfg


def _mono(audio: np.ndarray) -> np.ndarray:
    # the reference downmixes stereo by mean (scripts/remfx_detect.py:48);
    # a sum would be +6 dB hot and out of the classifier's level range
    return audio.mean(0, keepdims=True)


def detect_remove(chain, audio: np.ndarray, target: np.ndarray | None = None):
    """audio (1, T) mono -> (report, y (1, T')) on the chain's device:
    the classifier's probabilities and labels, then the removal of the
    detected effects; given the dry ``target`` (1, T), the SI-SDR of the
    input and of the output against it, both cropped as the chain crops."""
    device = next(chain.classifier.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(device)
    with torch.no_grad():
        probs = chain.classifier(x)[0].cpu().numpy()
    labels = chain.detect(x)
    y, _ = chain.remove(x, labels)
    lab = labels[0].cpu().numpy()
    report = {
        "detected_effects": [e for e, v in zip(ALL_EFFECTS, lab) if v > 0.5],
        "probs": {e: round(float(p), 3) for e, p in zip(ALL_EFFECTS, probs)},
        "removed": [
            EFFECT_CLASS_NAMES[k] for k in chain.effect_order
            if k in chain.models
            and lab[ALL_EFFECTS.index(EFFECT_CLASS_NAMES[k])] > 0.5
        ],
    }
    if target is not None:
        dry = torch.from_numpy(np.ascontiguousarray(target, np.float32))[None].to(device)
        # align with the chain's passthrough cropping (valid-conv
        # backbones shorten the output; a 1-sample slip craters SI-SDR)
        T = y.shape[-1]
        dry_c = causal_crop(dry, T) if dry.shape[-1] > T else dry
        in_c = causal_crop(x, T) if x.shape[-1] > T else x
        report["input_si_sdr_db"] = round(float(si_sdr(in_c, dry_c).mean()), 2)
        report["output_si_sdr_db"] = round(float(si_sdr(y, dry_c).mean()), 2)
    return report, y[0].cpu().numpy()


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    in_path = cfg.get("audio_input") or "demos/example_distortion_reverb.wav"
    out_path = cfg.get("output_path") or "demos/example_removed.wav"

    audio, sr = read_wav(in_path)
    if sr != cfg["sample_rate"]:
        raise SystemExit(f"expected {cfg['sample_rate']} Hz, {in_path} is {sr} Hz")
    audio = _mono(audio)
    chain = build_chain(trained_cfg(cfg), None, device=device_of(cfg))
    target = None
    if cfg.get("target"):
        target = _mono(read_wav(cfg["target"])[0])
    report, y = detect_remove(chain, audio, target)
    report = {"input": in_path, **report}
    write_wav(out_path, y, cfg["sample_rate"])
    report["output"] = out_path
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
