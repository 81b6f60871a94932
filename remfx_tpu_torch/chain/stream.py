"""Chunked streaming inference for audio of any length.

Counterpart of ``remfx_tpu/chain/stream.py``: the audio runs through the
chain in fixed windows of ``chunk`` samples that overlap by ``overlap``,
recombined by a linear crossfade; detection runs once, on the window with
the most energy, so that the whole file gets one set of effects, as the
reference's single whole-file classifier call does. The operations are
the JAX package's, in its order: one window per ``remove`` call, then the
crossfade in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from remfx_tpu_torch import ALL_EFFECTS


def _windows(T: int, chunk: int, hop: int) -> list[int]:
    """Window start offsets covering [0, T) with the last window
    right-aligned so no tail is lost."""
    if T <= chunk:
        return [0]
    starts = list(range(0, T - chunk, hop))
    starts.append(T - chunk)
    return starts


def stream_chain(chain, x: torch.Tensor, chunk: int = 262144,
                 overlap: int = 16384, labels=None):
    """x: (C, T) of any length, on the chain's device -> (y (C, T'),
    labels (5,)), both on that device.

    * T <= chunk: zero-pad to ``chunk``, crop back.
    * else: detect once on the highest-energy window (or take ``labels``),
      then run the removal stages window by window with those labels and
      crossfade.
    Without a classifier and without ``labels``, every effect is removed;
    under ``use_all_effect_models``, every effect is removed whatever the
    labels. T' == T unless the chain's models shorten their output (the
    TCN's valid convolutions): each window's output is then aligned to
    the window's tail.
    """
    C, T = x.shape
    # overlap only shapes the hop when windowing actually happens;
    # a short input (T <= chunk) is one zero-padded window regardless
    if T > chunk and not 0 <= overlap < chunk:
        raise ValueError(
            f"overlap={overlap} must satisfy 0 <= overlap < chunk={chunk} "
            "(hop would be zero/negative and windows would skip audio)"
        )
    starts = _windows(T, chunk, chunk - overlap)
    frames = torch.stack([x[:, s:s + min(chunk, T)] for s in starts])
    if frames.shape[-1] < chunk:
        frames = F.pad(frames, (0, chunk - frames.shape[-1]))

    # ---- detect once (classifier or provided labels) ----
    if labels is None:
        if chain.classifier is not None:
            energies = frames.pow(2).mean(dim=(1, 2))
            probe = frames[int(torch.argmax(energies))][None]
            labels = chain.detect(probe)[0]
        else:
            labels = torch.ones(len(ALL_EFFECTS))
    labels = torch.as_tensor(labels, dtype=torch.float32).to(x.device)
    # inference_use_all_effect_models holds for given labels too, as in
    # the chain's batch paths (reference remfx/models.py:65-78)
    if chain.use_all_effect_models:
        labels = torch.ones_like(labels)

    # ---- removal per window, same labels ----
    outs = [chain.remove(frames[i][None], labels[None])[0][0]
            for i in range(frames.shape[0])]
    out_len = outs[0].shape[-1]  # == chunk for length-preserving models
    # length-shortening models (valid-conv TCN) causal-crop to the
    # window's TAIL, so each output right-aligns at s + chunk
    shift = chunk - out_len

    if len(starts) == 1:
        # tail-aligned: input samples [shift, T) live at out[:, :T-shift]
        n = T - shift
        if n <= 0:
            raise ValueError(
                f"input length {T} is shorter than the chain's receptive "
                f"field ({shift} samples are cropped)"
            )
        return outs[0][:, :n], labels

    # ---- crossfade overlap-add ----
    y = torch.zeros(C, T, device=x.device)
    w = torch.zeros(1, T, device=x.device)
    # numpy's ramp (float64, rounded once), as the JAX package builds it
    ramp = torch.from_numpy(np.linspace(0.0, 1.0, overlap, dtype=np.float32)).to(x.device)
    for i, s in enumerate(starts):
        s2 = s + shift
        n = min(out_len, T - s2)
        if n <= 0:
            continue
        win = torch.ones(n, device=x.device)
        if i > 0 and n > overlap:
            win[:overlap] = ramp[:overlap]
        if i < len(starts) - 1 and n > overlap:
            win[-overlap:] = torch.minimum(win[-overlap:], ramp.flip(0))
        y[:, s2:s2 + n] += outs[i][:, :n] * win
        w[:, s2:s2 + n] += win
    return y / torch.clamp(w, min=1e-8), labels
