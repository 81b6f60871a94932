"""WAV read/write (numpy only): a copy of ``remfx_tpu/data/wav.py``.

Replaces torchaudio.load/save on the data path (reference
remfx/datasets.py:447-448,466-467). Supports the formats found in the
reference's starter datasets and in ``example.wav`` (IEEE float32,
format tag 3) plus PCM 16/24/32.

Layout convention matches torchaudio: arrays are ``(channels, samples)``
float32 in [-1, 1).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (audio (channels, samples) float32, sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", data, body)
            fmt_body, fmt_size = body, size
        elif cid == b"data":
            raw = data[body : body + size]
        pos = body + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, _, block_align, bits = fmt
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        # fmt layout: base(16) + cbSize(2) + validBits(2) + channelMask(4)
        # puts the SubFormat GUID at body+24; the GUID's FIRST two bytes
        # carry the real format tag (PCM/float GUIDs differ only there).
        if fmt_size >= 26:
            (tag,) = struct.unpack_from("<H", data, fmt_body + 24)
        # Fallback: infer from bit depth if the extension is truncated.
        if tag not in (_WAVE_FORMAT_PCM, _WAVE_FORMAT_IEEE_FLOAT):
            tag = _WAVE_FORMAT_IEEE_FLOAT if bits in (32, 64) else _WAVE_FORMAT_PCM

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {tag}")

    x = x[: (len(x) // channels) * channels]
    return np.ascontiguousarray(x.reshape(-1, channels).T), int(rate)


def write_wav(path, audio: np.ndarray, sample_rate: int, dtype: str = "float32"):
    """Write (channels, samples) audio. dtype: 'float32' or 'int16'."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, _ = audio.shape
    interleaved = np.ascontiguousarray(audio.T)
    if dtype == "float32":
        payload = interleaved.astype("<f4").tobytes()
        tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    elif dtype == "int16":
        clipped = np.clip(interleaved, -1.0, 1.0 - 1.0 / 32768.0)
        payload = (clipped * 32768.0).astype("<i2").tobytes()
        tag, bits = _WAVE_FORMAT_PCM, 16
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, tag, channels, sample_rate, byte_rate, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(hdr + payload)
