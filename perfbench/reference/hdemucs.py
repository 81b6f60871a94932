"""The plain fp32 HDemucs of the benchmark's reference (Demucs v3 hybrid,
torchaudio's ``HDemucs`` as the RemFX reference builds it: remfx/models.py:
307-324 of https://github.com/mhrice/RemFX).

Written from the published architecture (Defossez 2021, "Hybrid
Spectrogram and Waveform Source Separation") with torchaudio's state-dict
names, so the seeded state dict that the benchmark hands the program loads
here unchanged. Plain torch: complex ``torch.stft`` for the analysis, and
an inverse STFT of plain operations (``stft.istft``), which also runs on
meta tensors for the operation counts of ``perfbench/flops.py``.
"""

from __future__ import annotations

import math

import torch
import torch as th
import torch.nn.functional as F
from torch import nn

from perfbench.reference.stft import istft


def pad1d(x, paddings, mode="constant", value=0.0):
    length = x.shape[-1]
    if mode == "reflect":
        max_pad = max(paddings)
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            extra_pad_right = min(paddings[1], extra_pad)
            extra_pad_left = extra_pad - extra_pad_right
            paddings = (paddings[0] - extra_pad_left,
                        paddings[1] - extra_pad_right)
            x = F.pad(x, (extra_pad_left, extra_pad_right))
    return F.pad(x, paddings, mode, value)


def spectro(x, n_fft=512, hop_length=None):
    *other, length = x.shape
    x = x.reshape(-1, length)
    z = th.stft(
        x, n_fft, hop_length or n_fft // 4,
        window=th.hann_window(n_fft).to(x), win_length=n_fft,
        normalized=True, center=True, return_complex=True,
        pad_mode="reflect",
    )
    _, freqs, frame = z.shape
    return z.view(*other, freqs, frame)


def ispectro(z, hop_length=None, length=None):
    *other, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    z = z.view(-1, freqs, frames)
    x = istft(z, n_fft, hop_length, th.hann_window(n_fft).to(z.real),
              normalized=True, length=length)
    _, length = x.shape
    return x.view(*other, length)


class ScaledEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, scale=10.0, smooth=True):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        if smooth:
            weight = th.cumsum(self.embedding.weight.data, dim=0)
            weight = weight / th.arange(
                1, num_embeddings + 1
            ).sqrt()[:, None]
            self.embedding.weight.data[:] = weight
        self.embedding.weight.data /= scale
        self.scale = scale

    def forward(self, x):
        return self.embedding(x) * self.scale


class LayerScale(nn.Module):
    def __init__(self, channels, init=0):
        super().__init__()
        self.scale = nn.Parameter(th.zeros(channels, requires_grad=True))
        self.scale.data[:] = init

    def forward(self, x):
        return self.scale[:, None] * x


def unfold(a, kernel_size, stride):
    *shape, length = a.shape
    n_frames = math.ceil(length / stride)
    tgt_length = (n_frames - 1) * stride + kernel_size
    a = F.pad(a, (0, tgt_length - length))
    strides = list(a.stride())
    assert strides[-1] == 1
    strides = strides[:-1] + [stride, 1]
    return a.as_strided([*shape, n_frames, kernel_size], strides)


class BLSTM(nn.Module):
    def __init__(self, dim, layers=1, max_steps=None, skip=False):
        super().__init__()
        assert max_steps is None or max_steps % 4 == 0
        self.max_steps = max_steps
        self.lstm = nn.LSTM(bidirectional=True, num_layers=layers,
                            hidden_size=dim, input_size=dim)
        self.linear = nn.Linear(2 * dim, dim)
        self.skip = skip

    def forward(self, x):
        B, C, T = x.shape
        y = x
        framed = False
        if self.max_steps is not None and T > self.max_steps:
            width = self.max_steps
            stride = width // 2
            frames = unfold(x, width, stride)
            nframes = frames.shape[2]
            framed = True
            x = frames.permute(0, 2, 1, 3).reshape(-1, C, width)
        x = x.permute(2, 0, 1)
        x = self.lstm(x)[0]
        x = self.linear(x)
        x = x.permute(1, 2, 0)
        if framed:
            out = []
            frames = x.reshape(B, -1, C, width)
            limit = stride // 2
            for k in range(nframes):
                if k == 0:
                    out.append(frames[:, k, :, :-limit])
                elif k == nframes - 1:
                    out.append(frames[:, k, :, limit:])
                else:
                    out.append(frames[:, k, :, limit:-limit])
            out = th.cat(out, -1)
            out = out[..., :T]
            x = out
        if self.skip:
            x = x + y
        return x


class LocalState(nn.Module):
    def __init__(self, channels, heads=4, nfreqs=0, ndecay=4):
        super().__init__()
        assert channels % heads == 0
        self.heads = heads
        self.nfreqs = nfreqs
        self.ndecay = ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        if ndecay:
            self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
            self.query_decay.weight.data *= 0.01
            self.query_decay.bias.data[:] = -2
        self.proj = nn.Conv1d(channels + heads * nfreqs, channels, 1)

    def forward(self, x):
        B, C, T = x.shape
        heads = self.heads
        indexes = th.arange(T, device=x.device, dtype=x.dtype)
        delta = indexes[:, None] - indexes[None, :]
        queries = self.query(x).view(B, heads, -1, T)
        keys = self.key(x).view(B, heads, -1, T)
        dots = th.einsum("bhct,bhcs->bhts", keys, queries)
        dots /= keys.shape[2] ** 0.5
        if self.ndecay:
            decays = th.arange(1, self.ndecay + 1, device=x.device,
                               dtype=x.dtype)
            decay_q = self.query_decay(x).view(B, heads, -1, T)
            decay_q = th.sigmoid(decay_q) / 2
            decay_kernel = -decays.view(-1, 1, 1) * delta.abs() / (
                self.ndecay**0.5
            )
            dots += th.einsum("fts,bhfs->bhts", decay_kernel, decay_q)
        dots.masked_fill_(th.eye(T, device=dots.device, dtype=th.bool), -100)
        weights = th.softmax(dots, dim=2)
        content = self.content(x).view(B, heads, -1, T)
        result = th.einsum("bhts,bhct->bhcs", weights, content)
        result = result.reshape(B, -1, T)
        return x + self.proj(result)


class DConv(nn.Module):
    def __init__(self, channels, compress=4, depth=2, init=1e-4, norm=True,
                 attn=False, heads=4, ndecay=4, lstm=False, kernel=3):
        super().__init__()
        self.channels = channels
        self.depth = depth
        norm_fn = (lambda d: nn.GroupNorm(1, d)) if norm else (
            lambda d: nn.Identity())
        hidden = int(channels / compress)
        act = nn.GELU
        self.layers = nn.ModuleList([])
        for d in range(depth):
            dilation = 2**d
            padding = dilation * (kernel // 2)
            mods = [
                nn.Conv1d(channels, hidden, kernel, dilation=dilation,
                          padding=padding),
                norm_fn(hidden), act(),
                nn.Conv1d(hidden, 2 * channels, 1),
                norm_fn(2 * channels), nn.GLU(1),
                LayerScale(channels, init),
            ]
            if attn:
                mods.insert(3, LocalState(hidden, heads=heads, ndecay=ndecay))
            if lstm:
                mods.insert(3, BLSTM(hidden, layers=2, max_steps=200,
                                     skip=True))
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    def __init__(self, chin, chout, kernel_size=8, stride=4, norm_groups=4,
                 empty=False, freq=True, norm=True, context=0, dconv_kw={},
                 pad=True):
        super().__init__()
        norm_fn = (lambda d: nn.GroupNorm(norm_groups, d)) if norm else (
            lambda d: nn.Identity())
        pad_v = kernel_size // 4 if pad else 0
        klass = nn.Conv1d
        self.freq = freq
        self.kernel_size = kernel_size
        self.stride = stride
        self.empty = empty
        self.pad = pad_v
        if freq:
            kernel_size = [kernel_size, 1]
            stride = [stride, 1]
            pad_v = [pad_v, 0]
            klass = nn.Conv2d
        self.conv = klass(chin, chout, kernel_size, stride, pad_v)
        if self.empty:
            return
        self.norm1 = norm_fn(chout)
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.norm2 = norm_fn(2 * chout)
        self.dconv = DConv(chout, **dconv_kw)

    def forward(self, x, inject=None):
        if not self.freq and x.dim() == 4:
            B, C, Fr, T = x.shape
            x = x.view(B, -1, T)
        if not self.freq:
            le = x.shape[-1]
            if not le % self.stride == 0:
                x = F.pad(x, (0, self.stride - (le % self.stride)))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            assert inject.shape[-1] == y.shape[-1], (inject.shape, y.shape)
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = F.gelu(self.norm1(y))
        if self.freq:
            B, C, Fr, T = y.shape
            y = y.permute(0, 2, 1, 3).reshape(-1, C, T)
            y = self.dconv(y)
            y = y.view(B, Fr, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        z = self.norm2(self.rewrite(y))
        z = F.glu(z, dim=1)
        return z


class HDecLayer(nn.Module):
    def __init__(self, chin, chout, last=False, kernel_size=8, stride=4,
                 norm_groups=4, empty=False, freq=True, norm=True, context=1,
                 pad=True):
        super().__init__()
        norm_fn = (lambda d: nn.GroupNorm(norm_groups, d)) if norm else (
            lambda d: nn.Identity())
        pad_v = kernel_size // 4 if pad else 0
        self.pad = pad_v
        self.last = last
        self.freq = freq
        self.chin = chin
        self.empty = empty
        self.stride = stride
        self.kernel_size = kernel_size
        klass = nn.Conv1d
        klass_tr = nn.ConvTranspose1d
        if freq:
            kernel_size = [kernel_size, 1]
            stride = [stride, 1]
            klass = nn.Conv2d
            klass_tr = nn.ConvTranspose2d
        self.conv_tr = klass_tr(chin, chout, kernel_size, stride)
        self.norm2 = norm_fn(chout)
        if not self.empty:
            self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)
            self.norm1 = norm_fn(2 * chin)

    def forward(self, x, skip, length):
        if self.freq and x.dim() == 3:
            B, C, T = x.shape
            x = x.view(B, self.chin, -1, T)
        if not self.empty:
            x = x + skip
            y = F.glu(self.norm1(self.rewrite(x)), dim=1)
        else:
            y = x
            assert skip is None
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            if self.pad:
                z = z[..., self.pad : -self.pad, :]
        else:
            z = z[..., self.pad : self.pad + length]
            assert z.shape[-1] == length, (z.shape[-1], length)
        if not self.last:
            z = F.gelu(z)
        return z, y


class HDemucs(nn.Module):
    """Oracle HDemucs (cac mode, hybrid) with torchaudio-style ModuleList
    names freq_encoder/freq_decoder/time_encoder/time_decoder."""

    def __init__(self, sources=("mixture",), audio_channels=1, channels=48,
                 growth=2, nfft=4096, depth=6, freq_emb=0.2, emb_scale=10,
                 emb_smooth=True, kernel_size=8, time_stride=2, stride=4,
                 context=1, context_enc=0, norm_starts=4, norm_groups=4,
                 dconv_depth=2, dconv_comp=4, dconv_attn=4, dconv_lstm=4,
                 dconv_init=1e-4):
        super().__init__()
        self.audio_channels = audio_channels
        self.sources = sources
        self.depth = depth
        self.channels = channels
        self.nfft = nfft
        self.hop_length = nfft // 4
        self.freq_emb = None
        self.freq_encoder = nn.ModuleList()
        self.freq_decoder = nn.ModuleList()
        self.time_encoder = nn.ModuleList()
        self.time_decoder = nn.ModuleList()

        chin, chin_z = audio_channels, audio_channels * 2
        chout = chout_z = channels
        freqs = nfft // 2

        for index in range(depth):
            lstm = index >= dconv_lstm
            attn = index >= dconv_attn
            norm = index >= norm_starts
            freq = freqs > 1
            stri, ker = stride, kernel_size
            if not freq:
                ker, stri = time_stride * 2, time_stride
            pad = True
            last_freq = False
            if freq and freqs <= kernel_size:
                ker, pad, last_freq = freqs, False, True
            kw = {
                "kernel_size": ker, "stride": stri, "freq": freq,
                "pad": pad, "norm": norm, "norm_groups": norm_groups,
                "dconv_kw": {"lstm": lstm, "attn": attn,
                             "depth": dconv_depth, "compress": dconv_comp,
                             "init": dconv_init},
            }
            kwt = dict(kw)
            kwt["freq"] = 0
            kwt["kernel_size"] = kernel_size
            kwt["stride"] = stride
            kwt["pad"] = True
            kw_dec = {k: v for k, v in kw.items() if k != "dconv_kw"}

            enc = HEncLayer(chin_z, chout_z, context=context_enc, **kw)
            if freq:
                tenc = HEncLayer(chin, chout, context=context_enc,
                                 empty=last_freq,
                                 **{k: v for k, v in kwt.items()})
                self.time_encoder.append(tenc)
            self.freq_encoder.append(enc)
            if index == 0:
                chin = self.audio_channels * len(self.sources)
                chin_z = chin * 2
            dec = HDecLayer(chout_z, chin_z, last=index == 0,
                            context=context, **kw_dec)
            if freq:
                tdec = HDecLayer(chout, chin, empty=last_freq,
                                 last=index == 0, context=context,
                                 **{k: v for k, v in kwt.items()
                                    if k != "dconv_kw"})
                self.time_decoder.insert(0, tdec)
            self.freq_decoder.insert(0, dec)

            chin, chin_z = chout, chout_z
            chout, chout_z = int(growth * chout), int(growth * chout_z)
            if freq:
                freqs = 1 if freqs <= kernel_size else freqs // stride
            if index == 0 and freq_emb:
                self.freq_emb = ScaledEmbedding(freqs, chin_z,
                                                smooth=emb_smooth,
                                                scale=emb_scale)
                self.freq_emb_scale = freq_emb

    def _spec(self, x):
        hl = self.hop_length
        nfft = self.nfft
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        x = pad1d(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
        z = spectro(x, nfft, hl)[..., :-1, :]
        assert z.shape[-1] == le + 4, (z.shape, x.shape, le)
        return z[..., 2 : 2 + le]

    def _ispec(self, z, length=None):
        hl = self.hop_length
        z = F.pad(z, (0, 0, 0, 1))
        z = F.pad(z, (2, 2))
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        x = ispectro(z, hl, length=le)
        return x[..., pad : pad + length]

    def _magnitude(self, z):
        B, C, Fr, T = z.shape
        m = th.view_as_real(z).permute(0, 1, 4, 2, 3)
        return m.reshape(B, C * 2, Fr, T)

    def _mask(self, z, m):
        B, S, C, Fr, T = m.shape
        out = m.view(B, S, -1, 2, Fr, T).permute(0, 1, 2, 4, 5, 3)
        return th.view_as_complex(out.contiguous())

    def forward(self, mix):
        x = mix
        length = x.shape[-1]
        z = self._spec(mix)
        mag = self._magnitude(z)
        x = mag
        B, C, Fq, T = x.shape
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)

        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.freq_encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.time_encoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.time_encoder[idx]
                xt = tenc(xt)
                if not tenc.empty:
                    saved_t.append(xt)
                else:
                    inject = xt
            x = encode(x, inject)
            if idx == 0 and self.freq_emb is not None:
                frs = th.arange(x.shape[-2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].expand_as(x)
                x = x + self.freq_emb_scale * emb
            saved.append(x)

        x = th.zeros_like(x)
        xt = th.zeros_like(x)
        for idx, decode in enumerate(self.freq_decoder):
            skip = saved.pop(-1)
            x, pre = decode(x, skip, lengths.pop(-1))
            offset = self.depth - len(self.time_decoder)
            if idx >= offset:
                tdec = self.time_decoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tdec.empty:
                    assert pre.shape[2] == 1, pre.shape
                    pre = pre[:, :, 0]
                    xt, _ = tdec(pre, None, length_t)
                else:
                    skip = saved_t.pop(-1)
                    xt, _ = tdec(xt, skip, length_t)

        S = len(self.sources)
        x = x.view(B, S, -1, Fq, T)
        x = x * std[:, None] + mean[:, None]
        zout = self._mask(z, x)
        x = self._ispec(zout, length)
        xt = xt.view(B, S, -1, length)
        xt = xt * stdt[:, None] + meant[:, None]
        return (xt + x).reshape(B, -1, length)  # (B, S * C, T), as the removal models give
