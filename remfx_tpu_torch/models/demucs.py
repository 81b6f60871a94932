"""HDemucs — hybrid time + spectrogram U-Net (torchaudio's HDemucs).

Counterpart of ``remfx_tpu/models/demucs.py``, with torchaudio's
state-dict names (``freq_encoder``, ``freq_decoder``, ``time_encoder``,
``time_decoder``, ``freq_emb.embedding``): the names that
``remfx_tpu.compat.torch_import.export_demucs`` writes, so JAX weights
load with ``load_state_dict(strict=True)`` (``compat/from_jax.py``).
Layouts are PyTorch's: ``(B, C, T)`` for the time branch and
``(B, C, F, T)`` for the spectrogram branch.

Structure (defaults: depth 6, kernel 8, stride 4, growth 2):

* freq (z) branch: normalised STFT (nfft 4096, hop 1024, demucs' 3*hop/2
  reflect pre-pad and the ``[2:2+le]`` frame trim), complex as channels;
  the frequency axis is convolved (k8 s4 pad 2) until it is at most the
  kernel, which collapses it to 1 (pad 0); deeper layers convolve time
  (k4 s2). A learned ``ScaledEmbedding`` frequency embedding is added
  after layer 0 with weight 0.2.
* time (t) branch: conv1d encoders (k8 s4 pad 2) beside the freq layers;
  the one beside the collapsing freq layer is "empty" (conv only) and
  its output is added into that layer's conv output.
* each non-empty layer: conv -> [GroupNorm(4)] -> GELU (exact erf) ->
  DConv residual branch -> 1x1 rewrite -> [GroupNorm(4)] -> GLU.
* DConv: per depth d, conv k3 dilation 2^d -> GroupNorm(1) -> GELU ->
  [BLSTM on 200-step frames at stride 100, stitched from the centres]
  [LocalState attention with decay bias and a -100 diagonal] -> 1x1 to
  2C -> GroupNorm(1) -> GLU -> LayerScale (init 1e-4) -> + the input.
* decoders mirror the encoders with skip sums, 3x3 / k3 rewrites + GLU
  and transposed convs; the spectrogram output is de-normalised,
  iSTFT'd and summed with the de-normalised time-branch output.

Each GroupNorm and the activation after it is one ``GroupNormAct``
(``ops/group_norm.py``): torch's composition on the CPU, the fused kernel
of ``csrc/group_norm.cu`` on the card, in inference and under autograd
alike. A DConv depth's second norm also takes the LayerScale and the
residual add. The slots of the activations it absorbed hold parameter-free
``nn.Identity`` modules, so the state-dict names are torchaudio's still.

The JAX package computes the strided and transposed convolutions through
``ops/fastconv.py`` and ``ops/subpixel.py``, TPU workarounds whose values
are those of plain ``conv``/``conv_transpose``; here they are plain.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.lstm import LSTM
from remfx_tpu_torch.ops.group_norm import group_norm
from remfx_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from remfx_tpu_torch.utils.spans import span


NORM_GROUPS = 4
FREQ_EMB_WEIGHT = 0.2


class GroupNormAct(nn.GroupNorm):
    """``nn.GroupNorm`` and the activation after it, ``act`` "gelu" (the
    exact erf form, as the JAX module asks for) or "glu" (over the channel
    halves), in one call of ``ops/group_norm.py:group_norm``; with
    ``residual`` and ``scale``, ``residual + scale * glu``. Its parameters
    and their names are ``nn.GroupNorm``'s."""

    def __init__(self, num_groups: int, num_channels: int, act: str):
        super().__init__(num_groups, num_channels)
        self.act = act

    def forward(self, x, residual=None, scale=None):
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, self.act,
                          residual, scale)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, act={self.act}"


def _norm(norm: bool, channels: int, act: str | None) -> nn.Module:
    """GroupNorm(4) and ``act``, or either alone where the layer lacks it."""
    if norm and act:
        return GroupNormAct(NORM_GROUPS, channels, act)
    if norm:  # the last decoder, normed only where norm_starts is 0
        return nn.GroupNorm(NORM_GROUPS, channels)
    return {None: nn.Identity, "gelu": nn.GELU, "glu": lambda: nn.GLU(1)}[act]()


def _pad1d_reflect(x, left: int, right: int):
    """demucs pad1d: when the signal is shorter than the reflect pad,
    zero-extend and take the extension out of the reflect paddings (the
    total padded length is unchanged)."""
    length = x.shape[-1]
    if length <= max(left, right):
        extra = max(left, right) - length + 1
        extra_right = min(right, extra)
        extra_left = extra - extra_right
        x = F.pad(x, (extra_left, extra_right))
        left, right = left - extra_left, right - extra_right
    return F.pad(x, (left, right), mode="reflect")


class ScaledEmbedding(nn.Module):
    """Embedding whose stored weight is divided by ``scale`` (and smoothed
    by a cumsum at init) and multiplied back at lookup."""

    def __init__(self, num_embeddings: int, features: int, scale: float = 10.0,
                 smooth: bool = True):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, features)
        with torch.no_grad():
            w = self.embedding.weight
            if smooth:
                w.copy_(torch.cumsum(w, dim=0) / torch.arange(
                    1, num_embeddings + 1, dtype=w.dtype).sqrt()[:, None])
            w.div_(scale)
        self.scale = scale

    def forward(self) -> torch.Tensor:
        """-> (num_embeddings, features), the whole table."""
        return self.embedding.weight * self.scale


class LayerScale(nn.Module):
    def __init__(self, channels: int, init: float):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x):
        return self.scale[:, None] * x


def graph_engages(is_cuda: bool, grad_enabled: bool, training: bool, capturing: bool) -> bool:
    """Whether a ``BLSTM`` call replays a CUDA graph: inference on the card
    with autograd recording nothing, outside any capture. Every other call
    (the CPU, training, autograd, someone else's capture) runs eagerly."""
    return is_cuda and not grad_enabled and not training and not capturing


class BLSTM(nn.Module):
    """2-layer BiLSTM + Linear on overlapping frames of ``max_steps``
    (stride max_steps // 2), re-stitched from each frame's centre; residual
    skip. x: (B, C, T).

    Where ``graph_engages``, the block replays a CUDA graph of its work but
    the residual add: cuDNN's LSTM is a few small kernels a step, which the
    host otherwise issues one by one slower than the card runs them. A
    graph is kept for each key (the input's shape, dtype and device, and
    the parameters' data pointers, so moved or reassigned weights capture
    anew). A key's first call runs eagerly, so a shape that never comes
    back pays no capture; its second warms up on the capture stream and
    captures; from then on a call copies ``x`` into the graph's input and
    replays, and the residual add writes a fresh tensor, so no replay
    overwrites what a caller holds. The weights are read where they lie:
    cuDNN's copy of bf16 weights into one buffer (torch flattens no bf16
    LSTM) is in the graph, device copies with no host work, and the
    parameters' storage stays the caller's (DDP's, FSDP's). A module keeps
    ``graph_keys`` keys, the least recently used dropped first;
    ``train(True)`` drops them all. The graphs of a device share one memory
    pool, safe as their replays run one after another on the caller's
    stream and each keeps its input and output held, and one capture
    stream, so that the pool's blocks are reused across captures and one
    cuBLAS workspace (32 MiB on an H100) serves them all."""

    max_steps = 200
    graph_keys = 4
    # counters (utils/spans.py): calls that satisfy graph_engages, captures, replays
    card_calls = 0
    graph_captures = 0
    graph_replays = 0
    _capture_state = {}  # device -> (memory pool, capture stream)

    def __init__(self, dim: int):
        super().__init__()
        self.lstm = LSTM(dim, dim, num_layers=2, bidirectional=True)
        self.linear = nn.Linear(2 * dim, dim)
        # key -> (graph, its input, its output), or None after the first call
        self._graphs = OrderedDict()

    def train(self, mode: bool = True):
        if mode:
            self._graphs.clear()
        return super().train(mode)

    def __getstate__(self):
        # a copy (deepcopy, pickle) starts with no graphs: they are the card's
        return {**super().__getstate__(), "_graphs": OrderedDict()}

    def forward(self, x):
        capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
        if not graph_engages(x.is_cuda, torch.is_grad_enabled(), self.training, capturing):
            return self._stitched(x) + x
        BLSTM.card_calls += 1
        key = (tuple(x.shape), x.dtype, x.device, self._pointers())
        if key not in self._graphs:
            self._graphs[key] = None
            if len(self._graphs) > self.graph_keys:
                self._graphs.popitem(last=False)
            return self._stitched(x) + x
        self._graphs.move_to_end(key)
        if self._graphs[key] is None:
            self._graphs[key] = self._capture(x)
            BLSTM.graph_captures += 1
        graph, static_x, static_y = self._graphs[key]
        with span("lstm"):
            static_x.copy_(x)
            graph.replay()
            BLSTM.graph_replays += 1
            return static_y + x

    def _pointers(self) -> tuple:
        return tuple(p.data_ptr() for p in self.parameters())

    def _capture(self, x):
        """-> (graph, its input, its output) of ``_stitched`` at ``x``'s key,
        warmed up and captured on the device's capture stream."""
        device = x.device
        if device not in BLSTM._capture_state:
            with torch.cuda.device(device):
                BLSTM._capture_state[device] = (torch.cuda.graph_pool_handle(),
                                                torch.cuda.Stream(device))
        pool, stream = BLSTM._capture_state[device]
        static_x = x.clone(memory_format=torch.contiguous_format)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self._stitched(static_x)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of the caller's other threads (a loader's
        # pinned copies) do not break the capture
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            static_y = self._stitched(static_x)
        return graph, static_x, static_y

    def _stitched(self, x):
        """The block without its residual add."""
        B, C, T = x.shape
        framed = T > self.max_steps
        if framed:
            width = self.max_steps
            stride = width // 2
            nframes = -(-T // stride)
            tgt = (nframes - 1) * stride + width
            xp = F.pad(x, (0, tgt - T))
            frames = xp.unfold(-1, width, stride)  # (B, C, nframes, width)
            x = frames.permute(0, 2, 1, 3).reshape(B * nframes, C, width)
        s = self.linear(self.lstm(x.permute(2, 0, 1)))  # (T', B', C)
        x = s.permute(1, 2, 0)  # (B', C, T')
        if framed:
            frames = x.reshape(B, nframes, C, width)
            limit = stride // 2
            out = [frames[:, 0, :, :-limit]]
            out += [frames[:, k, :, limit:-limit] for k in range(1, nframes - 1)]
            if nframes > 1:
                out.append(frames[:, nframes - 1, :, limit:])
            x = torch.cat(out, dim=-1)[..., :T]
        return x


class LocalState(nn.Module):
    """Local attention with learned per-head decay envelopes; the position
    itself is masked with -100; residual through a 1x1 projection.
    x: (B, C, T)."""

    heads = 4
    ndecay = 4

    def __init__(self, channels: int):
        super().__init__()
        heads, ndecay = self.heads, self.ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
        with torch.no_grad():
            self.query_decay.weight.mul_(0.01)
            self.query_decay.bias.fill_(-2.0)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        B, C, T = x.shape
        h = self.heads
        idx = torch.arange(T, device=x.device, dtype=x.dtype)
        delta = (idx[:, None] - idx[None, :]).abs()
        queries = self.query(x).view(B, h, -1, T)
        keys = self.key(x).view(B, h, -1, T)
        # dots[b, h, t, s]: key position t against query position s
        dots = torch.einsum("bhct,bhcs->bhts", keys, queries)
        dots = dots / math.sqrt(keys.shape[2])
        decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
        decay_q = torch.sigmoid(self.query_decay(x).view(B, h, -1, T)) / 2
        decay_kernel = -decays.view(-1, 1, 1) * delta / math.sqrt(self.ndecay)
        dots = dots + torch.einsum("fts,bhfs->bhts", decay_kernel, decay_q)
        eye = torch.eye(T, device=x.device, dtype=torch.bool)
        dots = dots.masked_fill(eye, -100.0)
        weights = torch.softmax(dots, dim=2)
        content = self.content(x).view(B, h, -1, T)
        result = torch.einsum("bhts,bhct->bhcs", weights, content)
        return x + self.proj(result.reshape(B, -1, T))


class DConv(nn.Module):
    """Residual branch of dilated convs; x: (B, C, T). Each depth is one
    ``nn.Sequential`` so the indices match torchaudio's state dict; its
    second norm takes the GLU, the LayerScale and the residual add."""

    def __init__(self, channels: int, attn: bool = False, lstm: bool = False):
        super().__init__()
        hidden = channels // 4
        self.layers = nn.ModuleList()
        for d in range(2):
            dilation = 2**d
            mods = [
                nn.Conv1d(channels, hidden, 3, dilation=dilation,
                          padding=dilation),
                GroupNormAct(1, hidden, "gelu"),
                nn.Identity(),  # the GELU's slot
            ]
            if lstm:
                mods.append(BLSTM(hidden))
            if attn:
                mods.append(LocalState(hidden))
            # forward unpacks this layout by position: the body, the second
            # norm, the GLU's slot and the LayerScale, whose scale the norm
            # takes (LayerScale.forward is not called)
            mods += [
                nn.Conv1d(hidden, 2 * channels, 1),
                GroupNormAct(1, 2 * channels, "glu"),
                nn.Identity(),  # the GLU's slot
                LayerScale(channels, 1e-4),
            ]
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x):
        for layer in self.layers:
            *body, norm, _, layer_scale = layer
            h = x
            for module in body:
                h = module(h)
            x = norm(h, residual=x, scale=layer_scale.scale)
        return x


class HEncLayer(nn.Module):
    """freq=True: conv over the frequency axis of (B, C, F, T); else conv1d
    over (B, C, T). ``empty``: conv only (the time branch's inject layer)."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8,
                 stride: int = 4, empty: bool = False, freq: bool = True,
                 norm: bool = True, context: int = 0, dconv_lstm: bool = False,
                 dconv_attn: bool = False, pad: bool = True):
        super().__init__()
        pad_v = kernel_size // 4 if pad else 0
        self.freq = freq
        self.stride = stride
        self.empty = empty
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel_size, 1), (stride, 1),
                                  (pad_v, 0))
        else:
            self.conv = nn.Conv1d(chin, chout, kernel_size, stride, pad_v)
        if empty:
            return
        klass = nn.Conv2d if freq else nn.Conv1d
        self.norm1 = _norm(norm, chout, "gelu")
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.norm2 = _norm(norm, 2 * chout, "glu")
        self.dconv = DConv(chout, lstm=dconv_lstm, attn=dconv_attn)

    def forward(self, x, inject=None):
        if not self.freq:
            if x.dim() == 4:
                B, C, Fr, T = x.shape
                x = x.reshape(B, C * Fr, T)
            le = x.shape[-1]
            if le % self.stride != 0:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = self.norm1(y)
        if self.freq:
            # DConv over time with the frequency axis folded into the batch;
            # contiguous for the norms' kernel (at B = 1 the reshape is a view)
            B, C, Fr, T = y.shape
            h = y.permute(0, 2, 1, 3).reshape(B * Fr, C, T).contiguous()
            y = self.dconv(h).view(B, Fr, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return self.norm2(self.rewrite(y))


class HDecLayer(nn.Module):
    """Skip sum -> context rewrite + GLU -> transposed conv -> crop;
    returns (z, pre): ``pre`` feeds the empty time decoder."""

    def __init__(self, chin: int, chout: int, last: bool = False,
                 kernel_size: int = 8, stride: int = 4, empty: bool = False,
                 freq: bool = True, norm: bool = True, context: int = 1,
                 pad: bool = True):
        super().__init__()
        self.pad = kernel_size // 4 if pad else 0
        self.freq = freq
        self.chin = chin
        self.empty = empty
        if freq:
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel_size, 1),
                                              (stride, 1))
        else:
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel_size, stride)
        self.norm2 = _norm(norm, chout, None if last else "gelu")
        if not empty:
            klass = nn.Conv2d if freq else nn.Conv1d
            self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)
            self.norm1 = _norm(norm, 2 * chin, "glu")

    def forward(self, x, skip, length: int):
        if self.freq and x.dim() == 3:
            B, C, T = x.shape
            x = x.view(B, self.chin, -1, T)
        if not self.empty:
            x = x + skip
            y = self.norm1(self.rewrite(x))
        else:
            y = x
        z = self.norm2(self.conv_tr(y))  # with the GELU, before the crop
        if self.freq:
            if self.pad:
                z = z[..., self.pad : -self.pad, :]
        else:
            z = z[..., self.pad : self.pad + length]
        return z, y


def _layer_plan(nfft: int, depth: int, channels: int, audio_channels: int,
                n_sources: int = 1, growth: float = 2.0, kernel_size: int = 8,
                stride: int = 4, time_stride: int = 2, norm_starts: int = 4,
                dconv_lstm: int = 4, dconv_attn: int = 4):
    """Per-index layer configuration of the torch constructor (a copy of
    the JAX package's ``_layer_plan``)."""
    plan = []
    freqs = nfft // 2
    chin, chin_z = audio_channels, audio_channels * 2
    chout = chout_z = channels
    emb_dim = None
    emb_freqs = None
    for index in range(depth):
        freq = freqs > 1
        stri, ker, pad, last_freq = stride, kernel_size, True, False
        if not freq:
            ker, stri = time_stride * 2, time_stride
        if freq and freqs <= kernel_size:
            ker, pad, last_freq = freqs, False, True
        plan.append(dict(
            index=index, freq=freq, last_freq=last_freq,
            kernel=ker, stride=stri, pad=pad,
            norm=index >= norm_starts,
            lstm=index >= dconv_lstm, attn=index >= dconv_attn,
            chin=chin, chin_z=chin_z, chout=chout, chout_z=chout_z,
            dec_out=chin, dec_out_z=chin_z,
        ))
        if index == 0:
            # decoder 0 outputs sources * audio channels (cac: *2)
            plan[0]["dec_out"] = audio_channels * n_sources
            plan[0]["dec_out_z"] = audio_channels * n_sources * 2
            emb_freqs = freqs // stride
            emb_dim = chout_z
        chin, chin_z = chout, chout_z
        chout, chout_z = int(growth * chout), int(growth * chout_z)
        if freq:
            freqs = 1 if freqs <= kernel_size else freqs // stride
    return plan, emb_freqs, emb_dim


class HDemucs(nn.Module):
    """torchaudio-compatible HDemucs: (B, C, T) -> (B, len(sources)*C, T).

    ``depth`` is the total encoder depth (torch default 6: 5 freq layers +
    1 time layer for nfft 4096). ``zero_final`` zeroes the two final
    transposed convs, so that the network adds ~0 at init (pairs with the
    wrapper's residual skip for identity-start training).
    """

    def __init__(self, sources=("mixture",), audio_channels: int = 1,
                 channels: int = 48, nfft: int = 4096, depth: int = 6,
                 norm_starts: int = 4, dconv_lstm: int = 4,
                 dconv_attn: int = 4, zero_final: bool = False):
        super().__init__()
        self.sources = tuple(sources)
        self.audio_channels = audio_channels
        self.nfft = nfft
        self.hop_length = nfft // 4
        self.depth = depth
        plan, emb_freqs, emb_dim = _layer_plan(
            nfft, depth, channels, audio_channels, n_sources=len(self.sources),
            norm_starts=norm_starts, dconv_lstm=dconv_lstm,
            dconv_attn=dconv_attn,
        )
        self.freq_encoder = nn.ModuleList()
        self.freq_decoder = nn.ModuleList()
        self.time_encoder = nn.ModuleList()
        self.time_decoder = nn.ModuleList()
        for p in plan:
            last = p["index"] == 0
            self.freq_encoder.append(HEncLayer(
                p["chin_z"], p["chout_z"], kernel_size=p["kernel"],
                stride=p["stride"], freq=p["freq"], norm=p["norm"], pad=p["pad"],
                dconv_lstm=p["lstm"], dconv_attn=p["attn"],
            ))
            self.freq_decoder.insert(0, HDecLayer(
                p["chout_z"], p["dec_out_z"], last=last, kernel_size=p["kernel"],
                stride=p["stride"], freq=p["freq"], norm=p["norm"], pad=p["pad"],
            ))
            if p["freq"]:
                self.time_encoder.append(HEncLayer(
                    p["chin"], p["chout"], kernel_size=8, stride=4, freq=False,
                    empty=p["last_freq"], norm=p["norm"],
                    dconv_lstm=p["lstm"], dconv_attn=p["attn"],
                ))
                self.time_decoder.insert(0, HDecLayer(
                    p["chout"], p["dec_out"], last=last, kernel_size=8,
                    stride=4, freq=False, empty=p["last_freq"], norm=p["norm"],
                ))
        self.freq_emb = ScaledEmbedding(emb_freqs, emb_dim)
        self.register_buffer("window", hann_window(nfft), persistent=False)
        if zero_final:
            for layer in (self.freq_decoder[-1], self.time_decoder[-1]):
                nn.init.zeros_(layer.conv_tr.weight)
                nn.init.zeros_(layer.conv_tr.bias)

    # ---- spectral helpers (demucs _spec / _ispec) ----

    def _spec(self, x):
        """x (B, C, T) -> (re, im) each (B, C, nfft//2, le)."""
        hop = self.hop_length
        T = x.shape[-1]
        le = -(-T // hop)
        pad = hop // 2 * 3
        x = _pad1d_reflect(x, pad, pad + le * hop - T)
        re, im = stft_ri(x, self.nfft, hop, self.window)
        scale = 1.0 / math.sqrt(self.nfft)  # torch.stft(normalized=True)
        re, im = re[..., :-1, :] * scale, im[..., :-1, :] * scale
        return re[..., 2 : 2 + le], im[..., 2 : 2 + le]

    def _ispec(self, re, im, length: int):
        """Inverse of _spec: Nyquist re-pad, frame re-pad (2, 2),
        normalised istft, crop [pad : pad+length]."""
        hop = self.hop_length
        re = F.pad(re, (2, 2, 0, 1))
        im = F.pad(im, (2, 2, 0, 1))
        pad = hop // 2 * 3
        le = hop * int(math.ceil(length / hop)) + 2 * pad
        scale = math.sqrt(self.nfft)
        x = istft_ri(re * scale, im * scale, self.nfft, hop, self.window,
                     length=le)
        return x[..., pad : pad + length]

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        B, C, T = mix.shape
        S = len(self.sources)
        re, im = self._spec(mix)  # (B, C, F, N)
        Fq, N = re.shape[-2:]
        # complex as channels: (B, C, 2, F, N) -> (B, 2C, F, N)
        mag = torch.stack([re, im], dim=2).reshape(B, 2 * C, Fq, N)
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True)
        x = (mag - mean) / (1e-5 + std)

        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.freq_encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.time_encoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.time_encoder[idx]
                xt = tenc(xt)
                if tenc.empty:
                    inject = xt
                else:
                    saved_t.append(xt)
            x = encode(x, inject)
            if idx == 0:
                emb = self.freq_emb().t()  # (C, F)
                x = x + FREQ_EMB_WEIGHT * emb[None, :, :, None]
            saved.append(x)

        # the bottleneck reaches the decoders through the first skip only
        x = torch.zeros_like(x)
        xt = None
        offset = self.depth - len(self.time_decoder)
        for idx, decode in enumerate(self.freq_decoder):
            x, pre = decode(x, saved.pop(-1), lengths.pop(-1))
            if idx >= offset:
                tdec = self.time_decoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tdec.empty:
                    xt, _ = tdec(pre[:, :, 0], None, length_t)
                else:
                    xt, _ = tdec(xt, saved_t.pop(-1), length_t)

        zo = x.reshape(B, S * 2 * C, Fq, N) * std + mean
        zo = zo.reshape(B, S, C, 2, Fq, N)
        re_o = zo[:, :, :, 0].reshape(B, S * C, Fq, N)
        im_o = zo[:, :, :, 1].reshape(B, S * C, Fq, N)
        wave_f = self._ispec(re_o, im_o, T)
        wave_t = xt[..., :T] * stdt + meant
        return wave_f + wave_t

    def output_length(self, length: int) -> int:
        return length
