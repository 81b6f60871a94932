"""DPTNet: a dual-path transformer on a learned filterbank.

Counterpart of ``remfx_tpu/models/dptnet.py`` (the reference's
``DPTNetModel``, remfx/models.py:327-344, around asteroid's ``DPTNet(n_src=1,
in/out_chan=64, chunk_size=100, n_repeats=2, fb_name="free",
kernel_size=16, n_filters=64, stride=8)``):

* free-filterbank encoder: Conv1d 1 -> 64, kernel 16, stride 8, no
  bias, then ReLU (an input shorter than the kernel is zero-padded to
  it);
* gLN (``GlobLN``: mean and biased variance over channels and time per
  example);
* chunking: ``chunk_size`` frames at a hop of half a chunk, the frames
  padded by a whole chunk on both sides; ``n_repeats`` x [intra-chunk
  layer, inter-chunk layer]; fold back with the same padding, divided by
  the overlap ``chunk / hop``;
* each ``ImprovedTransformerLayer``: ``nn.MultiheadAttention`` (sequence
  first, dropout 0) + residual + gLN, then a BiLSTM (``dim_ff`` a
  direction) -> ReLU -> Linear + residual + gLN. The LSTM runs over the
  sequence axis of the ``(S, B, C)`` tensor, as the JAX package's does;
* head: PReLU + 1x1 Conv2d, fold, tanh gate x sigmoid gate (1x1 Conv1d
  each), ReLU mask on the encoder's output, and the free-filterbank
  decoder, a transposed Conv1d with its own filters, cut or padded to the
  input length.

State-dict names are asteroid's (``encoder.filterbank._filters``,
``masker.in_norm.gamma``, ``masker.layers.{r}.{0 intra, 1 inter}.mha.
in_proj_weight``, ``.recurrent.*``, ``.linear.*``, ``.norm_mha.*``,
``.norm_ff.*``, ``masker.first_out.{0 PReLU, 1 Conv2d}``, ``masker.net_out.0``,
``masker.net_gate.0``, ``decoder.filterbank._filters``), the names that
``remfx_tpu/compat/torch_import.py:convert_dptnet`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.lstm import LSTM


class GlobLN(nn.Module):
    """asteroid's gLN over ``(B, C, T)``: per example, over (C, T)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = x.mean(dim=(1, 2), keepdim=True)
        v = x.var(dim=(1, 2), unbiased=False, keepdim=True)
        return (x - m) / torch.sqrt(v + 1e-8) * self.gamma[:, None] + self.beta[:, None]


class ImprovedTransformerLayer(nn.Module):
    """MHA + residual + gLN, then (Bi)LSTM feed-forward + residual + gLN,
    over ``(S, B, C)`` sequence-first tensors."""

    def __init__(self, dim: int, n_heads: int = 4, dim_ff: int = 256,
                 bidirectional: bool = True):
        super().__init__()
        self.mha = nn.MultiheadAttention(dim, n_heads, dropout=0.0)
        self.recurrent = LSTM(dim, dim_ff, bidirectional=bidirectional)
        self.linear = nn.Linear(dim_ff * (2 if bidirectional else 1), dim)
        self.norm_mha = GlobLN(dim)
        self.norm_ff = GlobLN(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mha(x, x, x, need_weights=False)[0]
        x = self.norm_mha((x + h).permute(1, 2, 0)).permute(2, 0, 1)
        ff = self.linear(torch.relu(self.recurrent(x)))
        return self.norm_ff((x + ff).permute(1, 2, 0)).permute(2, 0, 1)


def _unfold(x: torch.Tensor, chunk: int, hop: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, chunk, n_chunks), the frames padded by ``chunk``
    on both sides."""
    xp = F.pad(x, (chunk, chunk))
    return xp.unfold(-1, chunk, hop).transpose(-1, -2)


def _fold(seg: torch.Tensor, T: int, hop: int) -> torch.Tensor:
    """Inverse of ``_unfold``: overlap-add of the chunks, the padding cut,
    divided by the overlap ``chunk / hop``."""
    B, C, chunk, n_chunks = seg.shape
    out = F.fold(seg.reshape(B, C * chunk, n_chunks), (T + 2 * chunk, 1),
                 kernel_size=(chunk, 1), stride=(hop, 1))
    return out[:, :, chunk: chunk + T, 0] / (chunk / hop)


class _Filterbank(nn.Module):
    """asteroid's free filterbank: the ``(n_filters, 1, kernel)`` filters."""

    def __init__(self, n_filters: int, kernel_size: int):
        super().__init__()
        self._filters = nn.Parameter(
            torch.randn(n_filters, 1, kernel_size) / math.sqrt(kernel_size))


class _Codec(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int):
        super().__init__()
        self.filterbank = _Filterbank(n_filters, kernel_size)


class _Masker(nn.Module):
    def __init__(self, in_chan, n_src, n_repeats, n_heads, dim_ff, bidirectional):
        super().__init__()
        self.in_norm = GlobLN(in_chan)
        self.layers = nn.ModuleList(
            nn.ModuleList([ImprovedTransformerLayer(in_chan, n_heads, dim_ff, True),
                           ImprovedTransformerLayer(in_chan, n_heads, dim_ff,
                                                    bidirectional)])
            for _ in range(n_repeats))
        self.first_out = nn.Sequential(nn.PReLU(), nn.Conv2d(in_chan, n_src * in_chan, 1))
        self.net_out = nn.Sequential(nn.Conv1d(in_chan, in_chan, 1), nn.Tanh())
        self.net_gate = nn.Sequential(nn.Conv1d(in_chan, in_chan, 1), nn.Sigmoid())


class DPTNet(nn.Module):
    def __init__(self, n_src: int = 1, in_chan: int = 64, out_chan: int = 64,
                 chunk_size: int = 100, n_repeats: int = 2, kernel_size: int = 16,
                 n_filters: int = 64, stride: int = 8, n_heads: int = 4,
                 dim_ff: int = 256, bidirectional: bool = True):
        super().__init__()
        self.n_src, self.in_chan = n_src, in_chan
        self.chunk_size, self.kernel_size, self.stride = chunk_size, kernel_size, stride
        self.encoder = _Codec(n_filters, kernel_size)
        self.masker = _Masker(in_chan, n_src, n_repeats, n_heads, dim_ff, bidirectional)
        self.decoder = _Codec(n_filters, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) -> an estimate of the same shape."""
        squeeze_ch = x.ndim == 3
        if squeeze_ch:
            x = x[:, 0, :]
        T_in = x.shape[-1]
        if T_in < self.kernel_size:
            x = F.pad(x, (0, self.kernel_size - T_in))
        tf = torch.relu(F.conv1d(x[:, None, :], self.encoder.filterbank._filters,
                                 stride=self.stride))  # (B, F, frames)
        n_frames = tf.shape[-1]
        m = self.masker
        hop = self.chunk_size // 2
        seg = _unfold(m.in_norm(tf), self.chunk_size, hop)  # (B, C, chunk, Kc)
        B, C, chunk, Kc = seg.shape
        for intra, inter in m.layers:
            # intra-chunk: the sequence is the position within a chunk
            s = intra(seg.permute(2, 0, 3, 1).reshape(chunk, B * Kc, C))
            seg = s.reshape(chunk, B, Kc, C).permute(1, 3, 0, 2)
            # inter-chunk: the sequence is the chunk index
            s = inter(seg.permute(3, 0, 2, 1).reshape(Kc, B * chunk, C))
            seg = s.reshape(Kc, B, chunk, C).permute(1, 3, 2, 0)
        folded = _fold(m.first_out(seg), n_frames, hop)  # (B, n_src * C, frames)
        folded = folded.reshape(B * self.n_src, self.in_chan, n_frames)
        mask = torch.relu(m.net_out(folded) * m.net_gate(folded))
        # the removal wrapper's one output is source 0's, as in the JAX package
        mask = mask.reshape(B, self.n_src, self.in_chan, n_frames)[:, 0]
        y = F.conv_transpose1d(tf * mask, self.decoder.filterbank._filters,
                               stride=self.stride)[:, 0, :]
        y = y[:, :T_in] if y.shape[-1] >= T_in else F.pad(y, (0, T_in - y.shape[-1]))
        return y[:, None, :] if squeeze_ch else y

    def output_length(self, length: int) -> int:
        return length
