"""DCUNet: a complex-valued U-Net over asteroid's STFT.

Counterpart of ``remfx_tpu/models/dcunet.py`` (reference ``DCUNetModel``,
remfx/models.py:347-367, wrapping ``asteroid.models.DCUNet(
"Large-DCUNet-20", stft_kernel_size=512, fix_length_mode="pad")``).
Layout is NCHW, with H the frequency axis and W the time axis.

* Front end: asteroid's STFTFB filterbank (sqrt periodic-Hann window,
  stride K/2, tight-frame scaling, DC and Nyquist rows / sqrt 2). The
  encoder is a framing ``conv1d`` with it and the decoder its
  ``conv_transpose1d`` (overlap-add, no NOLA division): no FFT, so no
  cuFFT question of the imaginary parts at DC and Nyquist arises.
* Masker: complex encoder blocks [ComplexConv -> norm -> leaky_relu
  0.01], decoder blocks [transposed ComplexConv -> norm -> leaky_relu]
  with the skip concatenated after each, a plain transposed ComplexConv
  output layer; the bounded mask ``tanh(|m|) m / |m|`` multiplies the
  input STFT.
* ``fix_length_mode "pad"``: time frames are zero-padded so that
  ``(N - 1) % prod(time strides) == 0``; a frequency count with
  ``(F - 1) % prod(freq strides) != 0`` raises ``TypeError``. "pad" is
  the only mode (the JAX package stores the field and always pads), so
  any other value raises ``ValueError`` rather than silently padding.
* ``identity_init`` adds the learnable ``masker.mask_bias`` (1.5, 0) to
  the raw mask, as the JAX package does (all vendored DCUNet ckpts set it).

State-dict names follow ``remfx_tpu/compat/torch_import.py:export_dcunet``
(``masker.encoders.{i}.conv.re_module.weight``, ``masker.decoders.{i}.
deconv...``, ``masker.output_layer...``, ``masker.mask_bias``), so
``tests/_torch_dcunet.py`` and ``compat.from_jax.dcunet_state_dict`` agree
with it. Train mode follows ``nn.Module.train()``; the JAX package's
``train`` argument is the module's ``training`` flag here.

The masker carries one tensor a block, in every mode: ``(B,
packed_width(2C), H, W)`` with the C real channels first and the C
imaginary ones after, packed from the STFT at one edge and unpacked from
the output layer at the other. Its layout is the one thing the mode
decides, at the packing: in eval ``torch.channels_last`` with zeros up to
a multiple of 8 channels (so that cuDNN's NHWC kernels pad nothing, and as
the epilogue kernel takes it), in train mode contiguous with no zeros
(cuDNN's fp32 NHWC convolutions are slower than its NCHW ones); every
layer after it follows the tensor it is handed
(``ops/dcunet_epilogue.py:packed_layout``). Each ``ComplexConv`` runs its
stacked ``2Cin -> 2Cout`` conv on it directly; a decoder's weight takes
the input channels in the order ``[h, skip]`` of the packed axis. Where
autograd records nothing the block weight is built once and kept until a
parameter changes (another tensor, or an in-place write such as
``load_state_dict``'s); where it records, it is built in the graph every
call. The norm, leaky ReLU and a decoder's skip concatenation are one call
of ``ops/dcunet_epilogue.py``, with the norm's (6, C) coefficients: from
the running statistics in eval (kept likewise), from the batch's in train
mode. That op alone picks the kernel or its plain, differentiable version.
So in inference cuDNN runs NHWC as the tensors lie, and no ``cat`` or
separate norm pass remains.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.batchnorm import BatchNorm2d, batch_statistics
from remfx_tpu_torch.ops.dcunet_epilogue import (CL, dcunet_epilogue, packed_layout,
                                                  packed_width, recorded)
from remfx_tpu_torch.parallel.mesh import batch_means, current_split

# (in_chan, out_chan, kernel (F, T), stride (F, T)) per encoder stage;
# paddings are asteroid "auto" = (k - 1) // 2
LARGE_DCUNET_20 = (
    (1, 45, (7, 1), (1, 1)),
    (45, 45, (1, 7), (1, 1)),
    (45, 90, (7, 5), (2, 2)),
    (90, 90, (7, 5), (2, 1)),
    (90, 90, (5, 3), (2, 2)),
    (90, 90, (5, 3), (2, 1)),
    (90, 90, (5, 3), (2, 2)),
    (90, 90, (5, 3), (2, 1)),
    (90, 90, (5, 3), (2, 2)),
    (90, 128, (5, 3), (2, 1)),
)

# the JAX package's test/streaming-size variant
MINI_DCUNET_6 = (
    (1, 16, (5, 1), (1, 1)),
    (16, 16, (1, 5), (1, 1)),
    (16, 32, (5, 3), (2, 2)),
    (32, 32, (3, 3), (2, 1)),
)

DCUNET_ARCHITECTURES = {
    "Large-DCUNet-20": LARGE_DCUNET_20,
    "Mini-DCUNet-6": MINI_DCUNET_6,
}


@lru_cache(maxsize=8)
def _stft_filters(kernel_size: int, n_filters: int | None = None) -> np.ndarray:
    """asteroid STFTFB filters ``(2 * (n // 2 + 1), n)`` float32, computed
    in float64 and rounded once, as the JAX package does. With
    ``n_filters > kernel_size`` the window is centre-padded with zeros.
    The cached array is shared: do not write to it."""
    K = kernel_size
    n = n_filters or K
    stride = K // 2
    cutoff = n // 2 + 1
    window = np.hanning(K + 1)[:-1] ** 0.5  # sqrt periodic hann
    if n > K:
        lpad = (n - K) // 2
        window = np.pad(window, (lpad, n - K - lpad))
    f = np.fft.fft(np.eye(n))
    f /= 0.5 * np.sqrt(K * n / stride)
    filters = np.concatenate([np.real(f[:cutoff]), np.imag(f[:cutoff])])
    filters[0, :] /= np.sqrt(2)
    filters[n // 2, :] /= np.sqrt(2)
    return (filters * window[None, :]).astype(np.float32)


def _filters_like(kernel_size: int, x: torch.Tensor, filters=None):
    if filters is None:
        filters = torch.from_numpy(_stft_filters(kernel_size))
    return filters.to(device=x.device, dtype=x.dtype)


def _stft_stacked(x: torch.Tensor, kernel_size: int, filters=None):
    """x (B, T) -> (B, 2F, N): the re rows, then the im rows."""
    filt = _filters_like(kernel_size, x, filters)
    return F.conv1d(x[:, None, :], filt[:, None, :], stride=kernel_size // 2)


def asteroid_stft(x: torch.Tensor, kernel_size: int, filters=None):
    """x (B, T) -> (re, im) each (B, F, N): asteroid's encoder, a valid
    framing conv at stride K/2 with no centring. ``filters`` may pass
    ``_stft_filters(kernel_size)`` already on the device."""
    y = _stft_stacked(x, kernel_size, filters)
    return y.chunk(2, dim=1)


def asteroid_istft(re: torch.Tensor, im: torch.Tensor, kernel_size: int,
                   length: int, filters=None) -> torch.Tensor:
    """(re, im) (B, F, N) -> (B, length): asteroid's decoder, the
    transposed filterbank with overlap-add at stride K/2 (tight frame, no
    NOLA division), zero-padded past its ``K + (K/2)(N-1)`` samples."""
    spec = torch.cat([re, im], dim=1)
    weight = _filters_like(kernel_size, spec, filters)[:, None, None, :]
    return _istft_stacked(spec, kernel_size, length, weight)


def _istft_stacked(spec: torch.Tensor, kernel_size: int, length: int, weight):
    """``asteroid_istft`` of the spectrum (B, C, N): the re rows, the im
    rows, then any rows of zeros, with the transposed conv's ``weight`` (C,
    O, 1, K), whose output channel 0 is the signal. A 2-d transposed conv
    over (B, C, 1, N), as ``conv_transpose1d`` runs it, but on ``spec``'s
    own layout: with frames outermost it is channels-last, which
    ``conv_transpose1d`` would copy to contiguous for cuDNN to transpose
    back."""
    K = kernel_size
    y = F.conv_transpose2d(spec.unsqueeze(2), weight, stride=(1, K // 2))[:, 0, 0]
    out_len = y.shape[-1]
    if out_len >= length:
        return y[:, :length]
    return F.pad(y, (0, length - out_len))


def _kept(owner: nn.Module, sources, build, *tags):
    """``build()`` (under no_grad), kept on ``owner`` and built again only
    when one of the tensors ``sources`` is another tensor (address, dtype
    or device) or was written in place since (its version counter), or the
    ``tags`` differ. The entry holds the sources it was built from, so that
    no new tensor can take one's address while it stands. A write through
    ``.data`` is not seen."""
    key = [(t.data_ptr(), t._version, t.dtype, t.device) for t in sources] + list(tags)
    entry = owner._eval_cache
    if entry is None or entry[0] != key:
        with torch.no_grad():
            entry = (key, [t.detach() for t in sources], build())
        owner._eval_cache = entry
    return entry[2]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or as it is where its type is wider (fp64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _weight(owner: nn.Module, sources, build, *tags):
    """``build()`` in autograd's graph where autograd records an operation
    on one of ``sources``; else kept on ``owner`` (``_kept``)."""
    if recorded(*sources):
        return build()
    return _kept(owner, sources, build, *tags)


class ComplexConv(nn.Module):
    """asteroid ComplexConv2d / ComplexConvTranspose2d (a ``re_module`` /
    ``im_module`` pair): ``y = (conv_r(xr) - conv_i(xi), conv_r(xi) +
    conv_i(xr))``, as one ``2Cin -> 2Cout`` real conv with the block kernel
    ``[[wr, wi], [-wi, wr]]``. The transposed form uses the weights as
    stored (torch tap order) with padding ``(k - 1) // 2``, which is the JAX
    package's flipped phase-split transpose cropped by ``(k - 1) // 2`` on
    each side.

    ``forward`` takes the masker's packed tensor, whose last ``skip`` of the
    ``in_ch`` complex input channels come from a skip: ``[h re, h im, skip
    re, skip im]``, then any zeros (``packed_width``); its output likewise,
    in the input's layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=(1, 1),
                 transpose: bool = False, use_bias: bool = False, skip: int = 0):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = tuple((k - 1) // 2 for k in self.kernel)
        self.transpose = transpose
        self.use_bias = use_bias
        self.skip = skip
        cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.re_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)
        self.im_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)
        self._eval_cache = None

    def _packed_weight(self, width: int, layout):
        """(weight, bias or None) of the stacked conv on a packed input of
        ``width`` channels in ``layout``: the block kernel ``[[wr, -wi], [wi,
        wr]]`` with its input channels in the packed order [h re, h im, skip
        re, skip im], and zeros for the input channels past them and the
        output channels up to ``packed_width``. Conv2d weights are (out, in,
        kh, kw), ConvTranspose2d's (in, out, kh, kw): the block kernel stacks
        on the other axes."""
        o, i = (1, 0) if self.transpose else (0, 1)
        h = self.re_module.in_channels - self.skip
        (rh, rs), (ih, is_) = (m.weight.split([h, self.skip], i)
                               for m in (self.re_module, self.im_module))
        w = torch.cat([torch.cat([rh, -ih, rs, -is_], i), torch.cat([ih, rh, is_, rs], i)], o)
        grow = {i: width - w.shape[i], o: packed_width(w.shape[o], layout) - w.shape[o]}
        w = F.pad(w, (0, 0, 0, 0, 0, grow[1], 0, grow[0]))
        bias = None
        if self.use_bias:
            br, bi = self.re_module.bias, self.im_module.bias
            bias = torch.cat([br - bi, br + bi])
            bias = F.pad(bias, (0, packed_width(len(bias), layout) - len(bias)))
        return w.contiguous(memory_format=layout), bias

    def forward(self, x):
        """x (B, packed_width(2 in_ch), H, W) -> (B, packed_width(2 out_ch),
        H', W'), in ``x``'s layout."""
        layout = packed_layout(x)
        w, b = _weight(self, list(self.parameters()),
                       lambda: self._packed_weight(x.shape[1], layout), x.shape[1], layout)
        if self.transpose:
            return F.conv_transpose2d(x, w, b, stride=self.stride, padding=self.padding)
        return F.conv2d(x, w, b, stride=self.stride, padding=self.padding)


class OnReImBatchNorm(nn.Module):
    """norm_type "bN": independent BatchNorm on re and im (eps 1e-5;
    flax momentum 0.9 is torch momentum 0.1), trained as flax trains it
    (``models/batchnorm.py``: the biased variance in ``running_var``)."""

    def __init__(self, features: int):
        super().__init__()
        self.re_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.im_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self._eval_cache = None

    def coefficients(self, x: torch.Tensor) -> torch.Tensor:
        """The norm of the packed ``x``'s first 2C channels as
        ``ops/dcunet_epilogue.py``'s diagonal (4, C) fp32 coefficients: ``a
        = w / sqrt(var + eps)`` of re and of im, then the biases ``b - mean
        * a``. Train mode takes the batch's statistics (``models/
        batchnorm.py``, of every channel at once: no slice of ``x`` for
        autograd to copy back) and moves the running ones toward them; eval
        the running statistics."""
        parts = (self.re_module, self.im_module)
        if self.training:
            C = self.re_module.num_features
            mean, var = batch_statistics(_wide(x))
            stats = [(mean[k * C:(k + 1) * C], var[k * C:(k + 1) * C]) for k in (0, 1)]
            for bn, (m, v) in zip(parts, stats):
                bn.track(m, v)
            return self._affine(stats)
        running = [(bn.running_mean, bn.running_var) for bn in parts]
        return _weight(self, list(self.parameters()) + [t for ts in running for t in ts],
                       lambda: self._affine(running))

    def _affine(self, stats):
        coef = []
        for bn, (mean, var) in zip((self.re_module, self.im_module), stats):
            a = _wide(bn.weight) * torch.rsqrt(_wide(var) + bn.eps)
            coef.append((a, _wide(bn.bias) - _wide(mean) * a))
        (ar, br), (ai, bi) = coef
        return torch.stack([ar, ai, br, bi])


class ComplexBatchNorm(nn.Module):
    """norm_type "CbN": complex whitening BatchNorm (Trabelsi et al. 2018)
    with asteroid's names: weight (C, 3) = [Wrr, Wri, Wii], bias (C, 2),
    running_mean (C, 2), running_covar (C, 3). Eval whitens with the
    running covariance; train with the batch's, and updates the running
    statistics at ``momentum``. A rank's part of a split batch
    (``parallel.split_batch``) takes the global batch's statistics."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        r = 1 / np.sqrt(2)
        init = torch.tensor([r, 0.0, r], dtype=torch.float32).repeat(features, 1)
        self.weight = nn.Parameter(init.clone())
        self.bias = nn.Parameter(torch.zeros(features, 2))
        self.register_buffer("running_mean", torch.zeros(features, 2))
        self.register_buffer("running_covar", init.clone())
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self._eval_cache = None

    def coefficients(self, x: torch.Tensor) -> torch.Tensor:
        """The norm of the packed ``x``'s first 2C channels as
        ``ops/dcunet_epilogue.py``'s (6, C) fp32 coefficients: the weight
        times the whitening, and the bias less that times the mean; of the
        batch in train mode (updating the running statistics), of the
        running statistics in eval."""
        if self.training:
            C = self.weight.shape[0]
            xr, xi, _ = _wide(x).split([C, C, x.shape[1] - 2 * C], 1)
            return self._affine(*self._batch_statistics(xr, xi))
        return _weight(self, [self.weight, self.bias, self.running_mean, self.running_covar],
                       lambda: self._affine(_wide(self.running_mean),
                                            _wide(self.running_covar)))

    def _batch_statistics(self, xr, xi):
        """(mean (C, 2), covariance (C, 3)) of the batch, differentiable;
        the running statistics updated with them."""
        axes = (0, 2, 3)
        rows = current_split()
        if rows is None:
            def means(*ts):
                return [t.mean(axes) for t in ts]
        else:  # a rank's part of the batch: the global batch's means
            def means(*ts):
                return batch_means(ts, axes, rows)
        mr, mi = means(xr, xi)
        cr, ci = xr - mr[:, None, None], xi - mi[:, None, None]
        vrr, vii, vri = means(cr * cr, ci * ci, cr * ci)
        mean, covar = torch.stack([mr, mi], dim=1), torch.stack([vrr, vri, vii], dim=1)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_covar.mul_(1 - m).add_(m * covar)
            self.num_batches_tracked += 1
        return mean, covar

    def _affine(self, m, v):
        """m (C, 2), v (C, 3) fp32 -> (6, C): the inverse square root of each
        channel's 2x2 covariance [[vrr, vri], [vri, vii]] (eps added) times
        the weight, and the bias less that times the mean."""
        vrr, vri, vii = v[:, 0] + self.eps, v[:, 1], v[:, 2] + self.eps
        s = torch.sqrt(vrr * vii - vri * vri)
        t = torch.sqrt(vrr + vii + 2 * s)
        inv_st = 1.0 / (s * t)
        rrr, rri, rii = (vii + s) * inv_st, -vri * inv_st, (vrr + s) * inv_st
        w, b = _wide(self.weight), _wide(self.bias)
        a = torch.stack([w[:, 0] * rrr + w[:, 1] * rri, w[:, 0] * rri + w[:, 1] * rii,
                         w[:, 1] * rrr + w[:, 2] * rri, w[:, 1] * rri + w[:, 2] * rii])
        shift = torch.stack([b[:, 0] - a[0] * m[:, 0] - a[1] * m[:, 1],
                             b[:, 1] - a[2] * m[:, 0] - a[3] * m[:, 1]])
        return torch.cat([a, shift])


def _norm(norm_type: str, features: int) -> nn.Module:
    if norm_type == "CbN":
        return ComplexBatchNorm(features)
    if norm_type == "bN":
        return OnReImBatchNorm(features)
    raise ValueError(f"unknown norm_type {norm_type!r}")


def _decoder_args(stages):
    """asteroid unet_decoder_args(skip_connections=True): decoder j
    inverts encoder -1-j; its input channels double where a skip concat
    feeds it. -> (dec_args, output_layer_args)."""
    args = []
    for cin, cout, kernel, stride in reversed(stages):
        skip = cout if args else 0
        args.append((cout + skip, cin, kernel, stride))
    return args[:-1], args[-1]


class _Block(nn.Module):
    """Complex conv -> norm -> leaky_relu(0.01) on the packed tensor, with
    a decoder's skip after it."""

    def __init__(self, args, norm_type: str, transpose: bool, skip: int = 0):
        super().__init__()
        cin, cout, kernel, stride = args
        conv = ComplexConv(cin, cout, kernel, stride, transpose=transpose, skip=skip)
        # asteroid's attribute names: "conv" in encoders, "deconv" in decoders
        self.conv_name = "deconv" if transpose else "conv"
        setattr(self, self.conv_name, conv)
        self.norm = _norm(norm_type, cout)
        self.out_channels = cout

    def forward(self, x, skip=None, skip_channels=0):
        """x packed -> the block's packed output; where a skip is given, its
        first ``skip_channels`` after the block's (the next decoder's
        input)."""
        y = getattr(self, self.conv_name)(x)
        return dcunet_epilogue(y, self.norm.coefficients(y), skip, skip_channels)


class _Masker(nn.Module):
    """asteroid's DCUMaskNet over the packed (B, packed_width(2), F, N), re,
    im and any channels of zeros -> the raw mask, packed likewise."""

    def __init__(self, stages, norm_type: str, identity_init: bool):
        super().__init__()
        self.encoders = nn.ModuleList([_Block(s, norm_type, False) for s in stages])
        dec_args, (cin, cout, kernel, stride) = _decoder_args(stages)

        def skip(j):  # complex channels of the skip in decoder j's input
            return stages[len(stages) - 1 - j][1] if j else 0

        self.decoders = nn.ModuleList(
            [_Block(a, norm_type, True, skip(j)) for j, a in enumerate(dec_args)])
        self.output_layer = ComplexConv(cin, cout, kernel, stride, transpose=True,
                                        skip=skip(len(dec_args)))
        if identity_init:
            self.mask_bias = nn.Parameter(torch.tensor([1.5, 0.0]))

    def forward(self, h):
        skips = []
        for enc in self.encoders:
            h = enc(h)
            skips.append((h, 2 * enc.out_channels))
        for k, dec in enumerate(self.decoders):
            h = dec(h, *skips[len(self.decoders) - 1 - k])
        return self.output_layer(h)


class DCUNet(nn.Module):
    def __init__(self, architecture: str = "Large-DCUNet-20",
                 stft_kernel_size: int = 512, fix_length_mode: str = "pad",
                 norm_type: str = "bN", identity_init: bool = False):
        super().__init__()
        self.architecture = architecture
        if fix_length_mode != "pad":
            raise ValueError(f"fix_length_mode {fix_length_mode!r} is not "
                             "supported; only 'pad' is")
        self.stft_kernel_size = stft_kernel_size
        self.identity_init = identity_init
        self.stages = DCUNET_ARCHITECTURES[architecture]
        self.freq_prod = int(np.prod([s[3][0] for s in self.stages]))
        self.time_prod = int(np.prod([s[3][1] for s in self.stages]))
        self.masker = _Masker(self.stages, norm_type, identity_init)
        self.register_buffer(
            "filters", torch.from_numpy(_stft_filters(stft_kernel_size).copy()),
            persistent=False)
        self._eval_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform -> the same shape."""
        squeeze_ch = x.dim() == 3
        if squeeze_ch:
            x = x[:, 0, :]
        T_in = x.shape[-1]
        K = self.stft_kernel_size
        if T_in < K:  # asteroid pads so that one full frame exists
            x = F.pad(x, (0, K - T_in))
        spec = _stft_stacked(x, K, self.filters)  # (B, 2F, N)
        re, im = spec.chunk(2, dim=1)
        F_full, N_in = re.shape[-2:]
        if (F_full - 1) % self.freq_prod:
            raise TypeError(
                f"freq axis {F_full} incompatible with architecture "
                f"{self.architecture} (needs (F-1) % {self.freq_prod} == 0); "
                "use a matching stft_kernel_size")
        pad_t = (-(N_in - 1)) % self.time_prod
        # the layout of the masker's packed tensor and of the ISTFT's
        # spectrum, the one thing train mode changes: channels-last with zeros
        # up to a multiple of 8 channels in eval (for cuDNN's NHWC kernels and
        # the epilogue kernel), contiguous with none in train mode, where
        # cuDNN's fp32 NHWC convolutions are the slower
        layout = torch.contiguous_format if self.training else CL
        h = torch.empty((x.shape[0], packed_width(2, layout), F_full, N_in + pad_t),
                        dtype=spec.dtype, device=spec.device, memory_format=layout).zero_()
        h[:, :2, :, :N_in] = spec.unflatten(1, (2, F_full))
        mr, mi = self.masker(h)[:, :2, :F_full, :N_in].unbind(1)
        if self.identity_init:
            mr = mr + self.masker.mask_bias[0]
            mi = mi + self.masker.mask_bias[1]
        # bounded complex mask: tanh(|m|) * m / |m|
        mag = torch.sqrt(mr * mr + mi * mi + 1e-12)
        scale = torch.tanh(mag) / mag
        mr, mi = mr * scale, mi * scale
        # the halves written where asteroid_istft's cat would put them
        out = self._istft_input(spec, layout)
        out[:, :F_full] = mr * re - mi * im
        out[:, F_full:2 * F_full] = mr * im + mi * re
        y = _istft_stacked(out, K, T_in, self._istft_weight(layout).to(spec.dtype))
        return y[:, None, :] if squeeze_ch else y

    @staticmethod
    def _istft_input(spec: torch.Tensor, layout) -> torch.Tensor:
        """The ISTFT's spectrum (B, packed_width(2F), N) for ``spec`` (B,
        2F, N), in its dtype (a bf16-mixed step's filters stay fp32): in
        ``layout`` channels-last, frames outermost with zero rows past the
        re and im ones; contiguous, as ``spec`` lies."""
        rows, channels, frames = spec.shape
        if layout != CL:
            return spec.new_empty(spec.shape)
        out = spec.new_empty((rows, frames, packed_width(channels)))
        out[..., channels:] = 0
        return out.transpose(1, 2)

    def _istft_weight(self, layout) -> torch.Tensor:
        """The ISTFT's transposed-conv weight, kept: the filters, in
        ``layout`` channels-last with zero rows up to ``packed_width`` and
        seven zero output channels, so that cuDNN's NHWC kernels pad and
        transpose nothing."""
        def build():
            f = self.filters
            w = f.new_zeros((packed_width(f.shape[0], layout), packed_width(1, layout), 1,
                             f.shape[1]))
            w[:f.shape[0], 0, 0] = f
            return w.contiguous(memory_format=layout)

        return _kept(self, [self.filters], build, layout)

    def output_length(self, length: int) -> int:
        return length

    def time_reach(self) -> tuple[int, int]:
        """Input samples on each side of an output sample that it can depend
        on (``parallel/sequence.py``). In frames: each encoder layer's
        ``ceil((k_t - 1) / 2)`` times the product of the time strides before
        it, and as much again for the decoder (or the output layer) that
        inverts it; 102 for Large-DCUNet-20, 10 for Mini-DCUNet-6. An output
        sample lies in two frames, whose masks reach that far on each side,
        hence two frames more, at the hop ``K / 2``."""
        frames, stride = 0, 1
        for _, _, (_, k_t), (_, s_t) in self.stages:
            frames += 2 * (k_t // 2) * stride
            stride *= s_t
        halo = (frames + 2) * (self.stft_kernel_size // 2)
        return halo, halo

    def time_alignment(self) -> int:
        """Samples between the frames at which the U-Net's time strides are
        in phase, ``(K / 2) * time_prod``: a window that starts on this grid
        has its frames and stride phases on the whole file's."""
        return self.stft_kernel_size // 2 * self.time_prod
