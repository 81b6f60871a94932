"""Polyphase hann-windowed sinc resampler (torchaudio ``sinc_interp_hann``).

Counterpart of ``remfx_tpu/ops/resample.py``: ``torchaudio.functional.
resample``'s defaults (lowpass_filter_width 6, rolloff 0.99), used for
dataset chunks at other rates and for Cnn14 at another model rate. The
kernel is built in float64 and rounded to float32 once, as the JAX
package builds it; the filter runs as one strided conv1d with ``new``
output channels, one per output phase.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int,
            rolloff: float):
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width, orig, new  # (new, kw)


def resample(x, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99):
    """``x (..., T)`` from ``orig_freq`` to ``new_freq`` Hz; a numpy array
    in gives a numpy array out, a tensor a tensor on its device."""
    if orig_freq == new_freq:
        return x
    as_numpy = isinstance(x, np.ndarray)
    xt = torch.from_numpy(np.ascontiguousarray(x)) if as_numpy else x
    kernels, width, orig, new = _kernel(int(orig_freq), int(new_freq),
                                        lowpass_filter_width, rolloff)
    batch_shape, length = xt.shape[:-1], xt.shape[-1]
    xf = F.pad(xt.reshape(-1, 1, length), (width, width + orig))
    k = torch.from_numpy(kernels)[:, None, :].to(device=xt.device, dtype=xt.dtype)
    y = F.conv1d(xf, k, stride=orig)  # (B, new, frames)
    y = y.transpose(1, 2).reshape(*batch_shape, -1)
    y = y[..., : math.ceil(new * length / orig)]
    return y.numpy() if as_numpy else y
