"""The general traffic generator: batches of audio crops and pinned label
matrices, drawn from the seed as a workload file's parameters say.

A row is a circular crop of one of the workload's audio files: a file, an
offset and a gain drawn from the seed (the demo files hold exactly one
crop's length, so a crop is the file rotated). Rows of a pair of files
(wet input, dry target) take the same file index, offset and gain. Offsets
are drawn without replacement within a batch, so no two rows of a batch
are alike. Labels put each effect on exactly its pinned count of rows, the
rows drawn afresh for every batch, so that every batch asks the same work
of the chain whatever the seed.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def read_wav(path) -> np.ndarray:
    """A mono WAV file of 32-bit floats or 16-bit integers -> float32."""
    data = (ROOT / path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF WAVE file")
    fmt, samples, i = None, None, 12
    while i + 8 <= len(data):
        cid, n = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])[0]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", data[i + 8:i + 24])
        elif cid == b"data":
            samples = data[i + 8:i + 8 + n]
        i += 8 + n + (n & 1)
    if fmt is None or samples is None or fmt[1] != 1:
        raise ValueError(f"{path}: needs one channel, a fmt and a data chunk")
    if fmt[0] == 3 and fmt[5] == 32:
        return np.frombuffer(samples, "<f4").astype(np.float32)
    if fmt[0] == 1 and fmt[5] == 16:
        return np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
    raise ValueError(f"{path}: format {fmt[0]} with {fmt[5]} bits")


def crops(sources, batches: int, rows: int, samples: int, gain_db, gen: torch.Generator,
          device) -> list[torch.Tensor]:
    """sources: [[path, ...], ...], each entry files of one length that are
    cropped alike (a wet file and its dry target). -> one tensor per file
    of an entry, (batches, rows, 1, samples) float32 on ``device``."""
    audio = [torch.from_numpy(np.stack([read_wav(p) for p in group])) for group in sources]
    length = audio[0].shape[-1]
    if any(a.shape[-1] != length for a in audio) or length < samples:
        raise ValueError("every source file needs one length of at least a crop")
    audio = torch.stack(audio).to(device)  # (files, parts, length)
    n = batches * rows
    which = torch.randint(len(sources), (n,), generator=gen)
    offset = torch.stack([torch.randperm(length, generator=gen)[:rows]
                          for _ in range(batches)]).reshape(n)
    lo, hi = gain_db
    gain = 10.0 ** ((lo + (hi - lo) * torch.rand(n, generator=gen)) / 20.0)
    index = (offset[:, None] + torch.arange(samples)[None, :]) % length  # (n, samples)
    out = []
    for part in range(audio.shape[1]):
        rows_of = audio[:, part][which.to(device)]  # (n, length)
        x = torch.gather(rows_of, 1, index.to(device)) * gain.to(device)[:, None]
        out.append(x.reshape(batches, rows, 1, samples))
    return out


def pinned_labels(counts, columns, batches: int, rows: int, gen: torch.Generator) -> torch.Tensor:
    """counts: {effect: rows it is on}; columns: the label matrix's effect
    order. -> (batches, rows, len(columns)) float32 of 0 and 1."""
    labels = torch.zeros(batches, rows, len(columns))
    for b in range(batches):
        for c, effect in enumerate(columns):
            labels[b, torch.randperm(rows, generator=gen)[:counts[effect]], c] = 1.0
    return labels
