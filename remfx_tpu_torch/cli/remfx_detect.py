"""Detect and remove on one file of any length, streamed.

Counterpart of ``scripts/remfx_detect.py`` (reference
scripts/remfx_detect.py): the chain of the config, run over the file in
fixed overlapping windows by ``chain/stream.py``, with detection once on
the loudest window.

    python -m remfx_tpu_torch.cli.remfx_detect +exp=remfx_detect \
        +audio_input=in.wav +output_path=out.wav [stream_chunk=N]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.chain.stream import stream_chain
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.data.wav import read_wav, write_wav
from remfx_tpu_torch.ops.resample import resample
from remfx_tpu_torch.train.loop import device_of


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    in_path = cfg.get("audio_input")
    if not in_path:
        raise SystemExit("pass +audio_input=path/to.wav")
    out_path = cfg.get("output_path") or "output.wav"
    device = device_of(cfg)

    audio, sr = read_wav(in_path)
    if sr != cfg["sample_rate"]:
        audio = resample(audio, sr, cfg["sample_rate"])
    # mono (1, T) by sum, as the JAX script downmixes
    audio = audio.sum(0, keepdims=True).astype(np.float32)

    chunk = int(cfg.get("stream_chunk", cfg["chunk_size"]))
    chain = build_chain(cfg, None, device=device)
    y, labels = stream_chain(chain, torch.from_numpy(audio).to(device), chunk=chunk)
    labels = labels.cpu().numpy()
    present = [
        name for name in chain.effect_order
        if labels[ALL_EFFECTS.index(EFFECT_CLASS_NAMES[name])] > 0.5
    ]
    print("Detected effects:", present)
    print("Removing effects...")
    write_wav(out_path, y[:, : audio.shape[-1]].cpu().numpy(), cfg["sample_rate"])
    print(f"Saved output to {out_path}")


if __name__ == "__main__":
    main()
