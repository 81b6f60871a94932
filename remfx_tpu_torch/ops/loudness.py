"""ITU-R BS.1770 integrated loudness (LUFS), batched.

Counterpart of ``remfx_tpu/ops/loudness.py``, with its parity target
``pyloudnorm.Meter.integrated_loudness`` ("K-weighting", as the
reference's ``LoudnessNormalize`` uses it, remfx/effects.py:619-629) and
its quirks:

  * K-weighting = RBJ high-shelf (+4 dB, 1500 Hz, Q 1/sqrt(2)), then an
    RBJ high-pass (38 Hz, Q 0.5), both designed at the working rate;
  * 400 ms gating blocks at 75 % overlap, ``round((T - 0.4)/0.1) + 1``
    of them; block j starts at ``int(j * 0.1 * sr)``, truncated per
    block; the last block may run past the end and is zero-padded;
  * absolute gate ``l_j >= -70``, relative gate ``l_j > Gamma_r`` and
    ``l_j > -70`` (strict); silence gives ``-inf``;
  * a signal shorter than one block takes the ungated loudness.

The port measures a batch at once: ``x (..., C, T)`` -> ``(...)``, where
the JAX package measures one ``(C, T)`` example under ``vmap``. It
filters and sums in float64 (see ``ops/biquad.py``: an fp32 scan loses
the 38 Hz high-pass) and returns fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from remfx_tpu_torch.ops.biquad import biquad_coeffs, biquad_filter

BLOCK_S = 0.4  # gating block, seconds
OVERLAP_STEP = 0.25  # block hop as a fraction of the block


def _highpass_coeffs(cutoff_freq, q_factor, sample_rate):
    """RBJ high-pass (pyloudnorm IIRfilter 'high_pass'), designed in
    float64 and rounded once to fp32, as in the JAX package."""
    w0 = 2.0 * np.pi * (cutoff_freq / sample_rate)
    alpha = np.sin(w0) / (2.0 * q_factor)
    cos_w0 = np.cos(w0)
    b = np.array([(1 + cos_w0) / 2, -(1 + cos_w0), (1 + cos_w0) / 2]) / (1 + alpha)
    a = np.array([1 + alpha, -2 * cos_w0, 1 - alpha]) / (1 + alpha)
    return (torch.tensor(b, dtype=torch.float32),
            torch.tensor(a, dtype=torch.float32))


def k_weighting_coeffs(sample_rate: float):
    """``(b, a)`` pairs of the two K-weighting stages at ``sample_rate``."""
    shelf = biquad_coeffs(4.0, 1500.0, 1.0 / np.sqrt(2.0), sample_rate, "high_shelf")
    return shelf, _highpass_coeffs(38.0, 0.5, sample_rate)


def _block_power(y: torch.Tensor, sample_rate: int, num_blocks: int) -> torch.Tensor:
    """Mean square of each gating block: ``y (..., T)`` -> ``(..., J)``."""
    block_len = int(BLOCK_S * sample_rate)
    starts = (np.arange(num_blocks) * (BLOCK_S * OVERLAP_STEP * sample_rate)
              ).astype(np.int64)
    pad = max(0, int(starts[-1]) + block_len - y.shape[-1])
    yp = F.pad(y, (0, pad))
    hops = np.diff(starts)
    if hops.size == 0 or (hops == hops[0]).all():
        # an even hop (any rate where 0.1 * sr is whole): a strided view
        hop = int(hops[0]) if hops.size else 1
        blocks = yp.unfold(-1, block_len, hop)[..., :num_blocks, :]
    else:
        idx = torch.as_tensor(starts[:, None] + np.arange(block_len)[None, :],
                              device=y.device)
        blocks = yp[..., idx]
    return torch.sum(blocks ** 2, dim=-1) / (BLOCK_S * sample_rate)


def integrated_loudness(x: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Integrated LUFS of ``x (..., C, T)`` (or ``(T,)`` mono) -> ``(...)``
    fp32. Channel weights are 1.0 (mono and stereo front channels)."""
    if x.dim() == 1:
        x = x[None, :]
    (b1, a1), (b2, a2) = k_weighting_coeffs(sample_rate)
    y = biquad_filter(b2, a2, biquad_filter(b1, a1, x.to(torch.float64)))

    duration = x.shape[-1] / sample_rate
    num_blocks = int(np.round((duration - BLOCK_S) / (BLOCK_S * OVERLAP_STEP))) + 1
    if num_blocks < 1:
        # shorter than one gating block (pyloudnorm is undefined here):
        # the ungated loudness of the whole signal
        power = torch.sum(torch.mean(y ** 2, dim=-1), dim=-1)
        return (-0.691 + 10.0 * torch.log10(power)).to(torch.float32)
    power = torch.sum(_block_power(y, sample_rate, num_blocks), dim=-2)  # (..., J)
    l_j = -0.691 + 10.0 * torch.log10(power)  # -inf for a silent block

    def gated_mean(gate):
        n = gate.sum(dim=-1)
        total = torch.where(gate, power, torch.zeros_like(power)).sum(dim=-1)
        return torch.where(n > 0, total / n.clamp_min(1), torch.zeros_like(total))

    gamma_r = -0.691 + 10.0 * torch.log10(gated_mean(l_j >= -70.0)) - 10.0
    gate = (l_j > gamma_r[..., None]) & (l_j > -70.0)
    return (-0.691 + 10.0 * torch.log10(gated_mean(gate))).to(torch.float32)


def loudness_normalize(x: torch.Tensor, sample_rate: int,
                       target_lufs_db: float = -32.0) -> torch.Tensor:
    """Gain each example of ``x (..., C, T)`` to the target integrated
    loudness, with the reference's clamp of the gain change to
    [-120, 40] dB (remfx/effects.py:625-629)."""
    lufs = integrated_loudness(x, sample_rate)
    delta = torch.clamp(target_lufs_db - lufs, -120.0, 40.0)
    gain = 10.0 ** (delta / 20.0)
    return gain[..., None, None] * x if x.dim() > 1 else gain * x

