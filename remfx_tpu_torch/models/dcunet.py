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

Two paths through the masker, one math:

* Inference (eval mode, stacked convs, and autograd recording nothing:
  grad mode off, or neither the input nor a parameter of the masker
  requiring grad): one
  tensor a block, ``(B, packed_width(2C), H, W)`` in
  ``torch.channels_last`` with the C real channels first, the C imaginary
  ones after and zeros up to a multiple of 8 (so that cuDNN's NHWC kernels
  pad nothing), packed from the STFT at one edge and unpacked from the
  output layer at the other. Each
  ``ComplexConv`` runs its stacked ``2Cin -> 2Cout`` conv on it directly,
  with the block weight built once and kept until a parameter changes
  (another tensor, or an in-place write such as ``load_state_dict``'s);
  a decoder's weight takes the input channels in the order ``[h, skip]``
  of the packed axis. The norm, leaky ReLU and a decoder's skip
  concatenation are one call of ``ops/dcunet_epilogue.py`` (the kernel on
  the card), its coefficients derived once from the norm's running
  statistics and weights. So cuDNN runs NHWC as the tensors lie, and no
  ``cat`` or separate norm pass remains.
* Everything else (train mode, batch statistics; ``gauss_conv``, whose
  three convolutions do not stack; an eval forward that autograd records,
  which the kernel cannot differentiate): (re, im) as two NCHW tensors,
  with the weight built and the skips concatenated every call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.batchnorm import BatchNorm2d
from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue, packed_width
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


def _kept(owner: nn.Module, sources, build):
    """``build()`` (under no_grad), kept on ``owner`` and built again only
    when one of the tensors ``sources`` is another tensor (address, dtype
    or device) or was written in place since (its version counter). The
    entry holds the sources it was built from, so that no new tensor can
    take one's address while it stands. A write through ``.data`` is not
    seen."""
    key = [(t.data_ptr(), t._version, t.dtype, t.device) for t in sources]
    entry = owner._eval_cache
    if entry is None or entry[0] != key:
        with torch.no_grad():
            entry = (key, [t.detach() for t in sources], build())
        owner._eval_cache = entry
    return entry[2]


class ComplexConv(nn.Module):
    """asteroid ComplexConv2d / ComplexConvTranspose2d (a ``re_module`` /
    ``im_module`` pair): ``y = (conv_r(xr) - conv_i(xi), conv_r(xi) +
    conv_i(xr))``.

    Two forms of the same math, as in the JAX package: stacked (default),
    one ``2Cin -> 2Cout`` real conv with the block kernel ``[[wr, wi],
    [-wi, wr]]``; or ``gauss``, Gauss's three-multiplication form. The
    transposed form uses the weights as stored (torch tap order) with
    padding ``(k - 1) // 2``, which is the JAX package's flipped phase-split
    transpose cropped by ``(k - 1) // 2`` on each side.

    ``forward`` takes (re, im); ``packed`` the stacked form on the masker's
    packed tensor, whose last ``skip`` of the ``in_ch`` complex input
    channels come from a skip: ``[h re, h im, skip re, skip im]``, then
    zeros up to ``packed_width``; its output likewise."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=(1, 1),
                 transpose: bool = False, use_bias: bool = False,
                 gauss: bool = False, skip: int = 0):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = tuple((k - 1) // 2 for k in self.kernel)
        self.transpose = transpose
        self.use_bias = use_bias
        self.gauss = gauss
        self.skip = skip
        cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.re_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)
        self.im_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)
        self._eval_cache = None

    def _conv(self, v, w, b=None):
        if self.transpose:
            return F.conv_transpose2d(v, w, b, stride=self.stride,
                                      padding=self.padding)
        return F.conv2d(v, w, b, stride=self.stride, padding=self.padding)

    def _block_weight(self):
        """The stacked kernel on inputs [xr, xi]. Conv2d weights are (out,
        in, kh, kw), ConvTranspose2d's (in, out, kh, kw): the block kernel
        stacks on the other axes."""
        wr, wi = self.re_module.weight, self.im_module.weight
        o, i = (1, 0) if self.transpose else (0, 1)
        return torch.cat([torch.cat([wr, -wi], dim=i),
                          torch.cat([wi, wr], dim=i)], dim=o)

    def forward(self, xr, xi):
        wr, wi = self.re_module.weight, self.im_module.weight
        if self.gauss:
            t1 = self._conv(xr, wr)
            t2 = self._conv(xi, wi)
            t3 = self._conv(xr + xi, wr + wi)
            yr, yi = t1 - t2, t3 - t1 - t2
        else:
            y = self._conv(torch.cat([xr, xi], dim=1), self._block_weight())
            yr, yi = y.chunk(2, dim=1)
        if self.use_bias:
            br, bi = self.re_module.bias, self.im_module.bias
            yr = yr + (br - bi)[:, None, None]
            yi = yi + (br + bi)[:, None, None]
        return yr, yi

    def _packed_weight(self):
        """(weight, bias or None) of the stacked conv on the packed input,
        channels-last: the block kernel's input channels permuted from
        [h re, skip re, h im, skip im] to the packed [h re, h im, skip re,
        skip im], and zeros for the padding channels of input and output."""
        w = self._block_weight()
        axis = 0 if self.transpose else 1
        cin, s = self.re_module.in_channels, self.skip
        if s:
            h = cin - s
            order = [torch.arange(h), cin + torch.arange(h), h + torch.arange(s),
                     cin + h + torch.arange(s)]
            w = w.index_select(axis, torch.cat(order).to(w.device))
        full = w.new_zeros([packed_width(n) if d < 2 else n for d, n in enumerate(w.shape)])
        full[:w.shape[0], :w.shape[1]] = w
        bias = None
        if self.use_bias:
            br, bi = self.re_module.bias, self.im_module.bias
            bias = torch.cat([br - bi, br + bi])
            bias = F.pad(bias, (0, packed_width(len(bias)) - len(bias)))
        return full.contiguous(memory_format=torch.channels_last), bias

    def packed(self, x):
        """x (B, packed_width(2 in_ch), H, W) -> (B, packed_width(2 out_ch),
        H', W'), with the kept weight."""
        params = list(self.parameters())
        w, b = _kept(self, params, self._packed_weight)
        return self._conv(x, w, b)


class OnReImBatchNorm(nn.Module):
    """norm_type "bN": independent BatchNorm on re and im (eps 1e-5;
    flax momentum 0.9 is torch momentum 0.1), trained as flax trains it
    (``models/batchnorm.py``: the biased variance in ``running_var``)."""

    def __init__(self, features: int):
        super().__init__()
        self.re_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.im_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self._eval_cache = None

    def forward(self, xr, xi):
        return self.re_module(xr), self.im_module(xi)

    def eval_affine(self) -> torch.Tensor:
        """The eval norm as ``ops/dcunet_epilogue.py``'s (6, C) fp32
        coefficients, kept until a parameter or statistic changes: the
        diagonal ``w / sqrt(var + eps)`` and the bias ``b - mean * a``."""
        def build():
            def part(bn):
                a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
                return a, bn.bias.float() - bn.running_mean.float() * a

            (ar, br), (ai, bi) = part(self.re_module), part(self.im_module)
            zero = torch.zeros_like(ar)
            return torch.stack([ar, zero, zero, ai, br, bi])

        sources = list(self.parameters()) + [self.re_module.running_mean,
                                             self.re_module.running_var,
                                             self.im_module.running_mean,
                                             self.im_module.running_var]
        return _kept(self, sources, build)


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

    def _whitening(self, vrr, vri, vii):
        """(rrr, rri, rii): the inverse square root of each channel's 2x2
        covariance [[vrr, vri], [vri, vii]] (eps added)."""
        s = torch.sqrt(vrr * vii - vri * vri)
        t = torch.sqrt(vrr + vii + 2 * s)
        inv_st = 1.0 / (s * t)
        return (vii + s) * inv_st, -vri * inv_st, (vrr + s) * inv_st

    def eval_affine(self) -> torch.Tensor:
        """The eval branch as ``ops/dcunet_epilogue.py``'s (6, C) fp32
        coefficients, kept until a parameter or statistic changes: the
        weight times the running whitening, and the bias less that times
        the running mean."""
        def build():
            m, v = self.running_mean.float(), self.running_covar.float()
            rrr, rri, rii = self._whitening(v[:, 0] + self.eps, v[:, 1],
                                            v[:, 2] + self.eps)
            w, b = self.weight.float(), self.bias.float()
            a = torch.stack([w[:, 0] * rrr + w[:, 1] * rri, w[:, 0] * rri + w[:, 1] * rii,
                             w[:, 1] * rrr + w[:, 2] * rri, w[:, 1] * rri + w[:, 2] * rii])
            shift = torch.stack([b[:, 0] - a[0] * m[:, 0] - a[1] * m[:, 1],
                                 b[:, 1] - a[2] * m[:, 0] - a[3] * m[:, 1]])
            return torch.cat([a, shift])

        return _kept(self, [self.weight, self.bias, self.running_mean,
                            self.running_covar], build)

    def forward(self, xr, xi):
        def bc(v):  # (C,) -> (1, C, 1, 1)
            return v[None, :, None, None]

        axes = (0, 2, 3)
        if self.training:
            rows = current_split()
            if rows is None:
                def means(*ts):
                    return [t.mean(axes) for t in ts]
            else:  # a rank's part of the batch: the global batch's means
                def means(*ts):
                    return batch_means(ts, axes, rows)
            mr, mi = means(xr, xi)
            cr, ci = xr - bc(mr), xi - bc(mi)
            vrr, vii, vri = means(cr * cr, ci * ci, cr * ci)
            vrr, vii = vrr + self.eps, vii + self.eps
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(
                    m * torch.stack([mr, mi], dim=1))
                self.running_covar.mul_(1 - m).add_(m * torch.stack(
                    [vrr - self.eps, vri, vii - self.eps], dim=1))
                self.num_batches_tracked += 1
        else:
            mr, mi = self.running_mean[:, 0], self.running_mean[:, 1]
            vrr = self.running_covar[:, 0] + self.eps
            vri = self.running_covar[:, 1]
            vii = self.running_covar[:, 2] + self.eps
            cr, ci = xr - bc(mr), xi - bc(mi)
        rrr, rri, rii = self._whitening(vrr, vri, vii)
        xh_r = bc(rrr) * cr + bc(rri) * ci
        xh_i = bc(rri) * cr + bc(rii) * ci
        w, b = self.weight, self.bias
        yr = bc(w[:, 0]) * xh_r + bc(w[:, 1]) * xh_i + bc(b[:, 0])
        yi = bc(w[:, 1]) * xh_r + bc(w[:, 2]) * xh_i + bc(b[:, 1])
        return yr, yi


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
    """Complex conv -> norm -> leaky_relu(0.01) on (re, im), or on the
    packed tensor (``packed``), with a decoder's skip after it."""

    def __init__(self, args, norm_type: str, transpose: bool, gauss: bool,
                 skip: int = 0):
        super().__init__()
        cin, cout, kernel, stride = args
        conv = ComplexConv(cin, cout, kernel, stride, transpose=transpose,
                           gauss=gauss, skip=skip)
        # asteroid's attribute names: "conv" in encoders, "deconv" in decoders
        self.conv_name = "deconv" if transpose else "conv"
        setattr(self, self.conv_name, conv)
        self.norm = _norm(norm_type, cout)
        self.out_channels = cout

    def forward(self, xr, xi):
        xr, xi = self.norm(*getattr(self, self.conv_name)(xr, xi))
        return F.leaky_relu(xr, 0.01), F.leaky_relu(xi, 0.01)

    def packed(self, x, skip=None, skip_channels=0):
        """x packed -> the block's packed output; where a skip is given, its
        first ``skip_channels`` after the block's (the next decoder's
        input)."""
        y = getattr(self, self.conv_name).packed(x)
        return dcunet_epilogue(y, self.norm.eval_affine(), skip, skip_channels)


class _Masker(nn.Module):
    """asteroid's DCUMaskNet over (re, im) (B, 1, F, N) -> the raw mask;
    ``packed`` over (B, 8, F, N), re, im and six channels of zeros."""

    def __init__(self, stages, norm_type: str, gauss: bool,
                 identity_init: bool):
        super().__init__()
        self.gauss = gauss
        self.encoders = nn.ModuleList(
            [_Block(s, norm_type, False, gauss) for s in stages])
        dec_args, (cin, cout, kernel, stride) = _decoder_args(stages)

        def skip(j):  # complex channels of the skip in decoder j's input
            return stages[len(stages) - 1 - j][1] if j else 0

        self.decoders = nn.ModuleList(
            [_Block(a, norm_type, True, gauss, skip(j)) for j, a in enumerate(dec_args)])
        self.output_layer = ComplexConv(cin, cout, kernel, stride, transpose=True,
                                        gauss=gauss, skip=skip(len(dec_args)))
        if identity_init:
            self.mask_bias = nn.Parameter(torch.tensor([1.5, 0.0]))

    def forward(self, hr, hi):
        skips = []
        for enc in self.encoders:
            hr, hi = enc(hr, hi)
            skips.append((hr, hi))
        for k, dec in enumerate(self.decoders):
            hr, hi = dec(hr, hi)
            sr, si = skips[len(self.decoders) - 1 - k]
            hr, hi = torch.cat([hr, sr], dim=1), torch.cat([hi, si], dim=1)
        return self.output_layer(hr, hi)

    def packed(self, h):
        """``forward`` on one packed channels-last tensor, in eval mode."""
        skips = []
        for enc in self.encoders:
            h = enc.packed(h)
            skips.append((h, 2 * enc.out_channels))
        for k, dec in enumerate(self.decoders):
            h = dec.packed(h, *skips[len(self.decoders) - 1 - k])
        return self.output_layer.packed(h)


class DCUNet(nn.Module):
    def __init__(self, architecture: str = "Large-DCUNet-20",
                 stft_kernel_size: int = 512, fix_length_mode: str = "pad",
                 norm_type: str = "bN", gauss_conv: bool = False,
                 identity_init: bool = False):
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
        self.masker = _Masker(self.stages, norm_type, gauss_conv, identity_init)
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
        # inference takes the packed path (module docstring)
        recorded = torch.is_grad_enabled() and (
            spec.requires_grad or any(p.requires_grad for p in self.masker.parameters()))
        packed = not (self.training or self.masker.gauss or recorded)
        if packed:
            h = torch.empty((x.shape[0], packed_width(2), F_full, N_in + pad_t),
                            dtype=spec.dtype, device=spec.device,
                            memory_format=torch.channels_last).zero_()
            h[:, :2, :, :N_in] = spec.unflatten(1, (2, F_full))
            mr, mi = self.masker.packed(h)[:, :2].unbind(1)
        else:
            mr, mi = self.masker(F.pad(re, (0, pad_t))[:, None],
                                 F.pad(im, (0, pad_t))[:, None])
            mr, mi = mr[:, 0], mi[:, 0]
        mr = mr[:, :F_full, :N_in]
        mi = mi[:, :F_full, :N_in]
        if self.identity_init:
            mr = mr + self.masker.mask_bias[0]
            mi = mi + self.masker.mask_bias[1]
        # bounded complex mask: tanh(|m|) * m / |m|
        mag = torch.sqrt(mr * mr + mi * mi + 1e-12)
        scale = torch.tanh(mag) / mag
        mr, mi = mr * scale, mi * scale
        if packed:  # the halves written where asteroid_istft's cat would put them
            out = self._istft_input(spec.shape[0], N_in)
            torch.sub(mr * re, mi * im, out=out[:, :F_full])
            torch.add(mr * im, mi * re, out=out[:, F_full:2 * F_full])
            y = _istft_stacked(out, K, T_in, self._istft_weight())
        else:
            y = asteroid_istft(mr * re - mi * im, mr * im + mi * re, K, T_in, self.filters)
        return y[:, None, :] if squeeze_ch else y

    def _istft_input(self, rows: int, frames: int) -> torch.Tensor:
        """The packed path's spectrum (rows, packed_width(2F), frames),
        frames outermost (channels-last for the transposed conv), its rows
        past the re and im ones zero."""
        width = packed_width(self.filters.shape[0])
        out = self.filters.new_empty((rows, frames, width))
        out[..., self.filters.shape[0]:] = 0
        return out.transpose(1, 2)

    def _istft_weight(self) -> torch.Tensor:
        """The packed path's transposed-conv weight: the filters, zero rows
        up to ``packed_width`` and seven zero output channels, so that
        cuDNN's NHWC kernels pad and transpose nothing; kept."""
        def build():
            f = self.filters
            w = f.new_zeros((packed_width(f.shape[0]), 8, 1, f.shape[1]))
            w[:f.shape[0], 0, 0] = f
            return w.contiguous(memory_format=torch.channels_last)

        return _kept(self, [self.filters], build)

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
