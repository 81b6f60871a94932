"""The plain fp32 DPTNet of the benchmark's reference: the dual-path
transformer network (Chen, Mao and Liu, Interspeech 2020, arXiv:2007.13975)
as asteroid's ``DPTNet`` builds it for the RemFX reference
(remfx/models.py:327-344, cfg/model/dptnet.yaml:11-22 of
https://github.com/mhrice/RemFX).

Written from asteroid's equations, with asteroid's state-dict names, so the
seeded state dict that the benchmark hands the program loads here unchanged
(``load_state_dict(strict=True)`` both ways):

* encoder: ``conv1d(wav, filters, stride)`` of the free filterbank
  (``encoder.filterbank._filters``, ``(n_filters, 1, kernel)``), then ReLU;
* masker: gLN over (channels, frames); the frames padded by ``chunk`` on
  both sides and cut into chunks of ``chunk`` at a hop of ``chunk // 2`` by
  explicit indices; ``n_repeats`` x [intra-chunk layer, inter-chunk layer],
  each an improved transformer layer over sequences of a chunk's
  positions, or of a position's chunks; PReLU and a 1x1 Conv2d; overlap-add
  by explicit indices, divided by ``chunk / hop``; ``tanh(conv) *
  sigmoid(conv)`` and the ReLU mask;
* the improved transformer layer, over ``(N, C, L)`` (N sequences of L):
  multi-head attention written as explicit products (``in_proj_weight``
  split into q, k, v; scores scaled by 1 / sqrt(C / heads); softmax over
  keys; ``out_proj``) + residual + gLN; then a BiLSTM (``ff_hid`` a
  direction, batch first) -> ReLU -> Linear + residual + gLN;
* gLN: per item, the mean and biased variance over (channels, time),
  ``(x - mean) / sqrt(var + 1e-8) * gamma + beta``;
* decoder: ``conv_transpose1d`` of the masked representation with the
  decoder's filters, cut or zero-padded to the input's length.

Departures from asteroid: dropout is left out (asteroid's DPTNet has
dropout 0); ``n_src`` is 1 and the mask is the removal output's one
source; an input shorter than the kernel is zero-padded to it (asteroid
raises); ``num_bins`` (RemFX passes it) is accepted and unused; the
initial weights are the benchmark's seeded ones, not asteroid's
xavier-normal filterbanks and torch's attention init. ``n_heads`` and
``ff_hid`` are asteroid's keyword arguments, at its defaults (4 and 256)
unless given.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-8


class GlobLN(nn.Module):
    """asteroid's gLN over ``(N, C, L)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        normed = (x - mean) / torch.sqrt(var + EPS)
        return normed * self.gamma[None, :, None] + self.beta[None, :, None]


class Attention(nn.Module):
    """torch's ``nn.MultiheadAttention`` parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), its products written out."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        """x: (N, L, C) -> (N, L, C), every position attending to all."""
        n, length, dim = x.shape
        d = dim // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(t):
            return t.reshape(n, length, self.heads, d).transpose(1, 2)  # (N, H, L, d)

        q, k, v = heads(x @ wq.T + bq), heads(x @ wk.T + bk), heads(x @ wv.T + bv)
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        out = torch.softmax(scores, dim=-1) @ v  # (N, H, L, d)
        return self.out_proj(out.transpose(1, 2).reshape(n, length, dim))


class ImprovedTransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ff_hid: int, bidirectional: bool):
        super().__init__()
        self.mha = Attention(dim, heads)
        self.recurrent = nn.LSTM(dim, ff_hid, batch_first=True, bidirectional=bidirectional)
        self.linear = nn.Linear(ff_hid * (2 if bidirectional else 1), dim)
        self.norm_mha = GlobLN(dim)
        self.norm_ff = GlobLN(dim)

    def forward(self, x):
        """x: (N, C, L) -> (N, C, L)."""
        x = self.norm_mha(x + self.mha(x.transpose(1, 2)).transpose(1, 2))
        ff = self.linear(torch.relu(self.recurrent(x.transpose(1, 2))[0]))
        return self.norm_ff(x + ff.transpose(1, 2))


def chunk_index(frames: int, chunk: int, hop: int) -> torch.Tensor:
    """(n_chunks, chunk) positions, in the frames padded by ``chunk`` on
    both sides, of each chunk's entries."""
    n_chunks = (frames + 2 * chunk - chunk) // hop + 1
    return torch.arange(n_chunks)[:, None] * hop + torch.arange(chunk)[None, :]


class _Filterbank(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int):
        super().__init__()
        self._filters = nn.Parameter(torch.empty(n_filters, 1, kernel_size))
        nn.init.xavier_normal_(self._filters)


class _Codec(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int):
        super().__init__()
        self.filterbank = _Filterbank(n_filters, kernel_size)


class _Masker(nn.Module):
    def __init__(self, chan: int, n_repeats: int, heads: int, ff_hid: int):
        super().__init__()
        self.in_norm = GlobLN(chan)
        self.layers = nn.ModuleList(
            nn.ModuleList([ImprovedTransformerLayer(chan, heads, ff_hid, True),
                           ImprovedTransformerLayer(chan, heads, ff_hid, True)])
            for _ in range(n_repeats))
        self.first_out = nn.Sequential(nn.PReLU(), nn.Conv2d(chan, chan, 1))
        self.net_out = nn.Sequential(nn.Conv1d(chan, chan, 1), nn.Tanh())
        self.net_gate = nn.Sequential(nn.Conv1d(chan, chan, 1), nn.Sigmoid())


class DPTNet(nn.Module):
    def __init__(self, n_src: int = 1, in_chan: int = 64, out_chan: int = 64,
                 chunk_size: int = 100, n_repeats: int = 2, fb_name: str = "free",
                 kernel_size: int = 16, n_filters: int = 64, stride: int = 8,
                 n_heads: int = 4, ff_hid: int = 256, num_bins: int = 1025):
        super().__init__()
        if n_src != 1 or fb_name != "free" or not in_chan == out_chan == n_filters:
            raise ValueError("the reference DPTNet takes one source and a free "
                             "filterbank whose filters are the masker's channels")
        self.chunk, self.hop = chunk_size, chunk_size // 2
        self.kernel_size, self.stride = kernel_size, stride
        self.encoder = _Codec(n_filters, kernel_size)
        self.masker = _Masker(in_chan, n_repeats, n_heads, ff_hid)
        self.decoder = _Codec(n_filters, kernel_size)

    def mask(self, w):
        """w: (B, C, frames), the encoder's output -> the ReLU mask."""
        m = self.masker
        b, c, frames = w.shape
        chunk, hop = self.chunk, self.hop
        index = chunk_index(frames, chunk, hop).to(w.device)  # (K, chunk)
        n_chunks = index.shape[0]
        padded = F.pad(m.in_norm(w), (chunk, chunk))
        seg = padded[:, :, index]  # (B, C, K, chunk)
        for intra, inter in m.layers:
            # intra-chunk: B * K sequences of ``chunk`` positions
            s = intra(seg.permute(0, 2, 1, 3).reshape(b * n_chunks, c, chunk))
            seg = s.reshape(b, n_chunks, c, chunk).permute(0, 2, 1, 3)
            # inter-chunk: B * chunk sequences of K chunks
            s = inter(seg.permute(0, 3, 1, 2).reshape(b * chunk, c, n_chunks))
            seg = s.reshape(b, chunk, c, n_chunks).permute(0, 2, 3, 1)
        seg = m.first_out(seg)  # (B, C, K, chunk)
        summed = torch.zeros(b, c, frames + 2 * chunk, dtype=seg.dtype, device=seg.device)
        summed = summed.index_add(2, index.reshape(-1), seg.reshape(b, c, -1))
        folded = summed[:, :, chunk:chunk + frames] / (chunk / hop)
        return torch.relu(m.net_out(folded) * m.net_gate(folded))

    def forward(self, x):
        """x: (B, 1, T) -> (B, 1, T)."""
        length = x.shape[-1]
        wav = F.pad(x, (0, max(0, self.kernel_size - length)))
        w = torch.relu(F.conv1d(wav, self.encoder.filterbank._filters, stride=self.stride))
        y = F.conv_transpose1d(w * self.mask(w), self.decoder.filterbank._filters,
                               stride=self.stride)
        return F.pad(y, (0, length - y.shape[-1])) if y.shape[-1] < length else y[..., :length]
