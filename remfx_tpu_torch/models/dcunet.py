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
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models.batchnorm import BatchNorm2d
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


def asteroid_stft(x: torch.Tensor, kernel_size: int, filters=None):
    """x (B, T) -> (re, im) each (B, F, N): asteroid's encoder, a valid
    framing conv at stride K/2 with no centring. ``filters`` may pass
    ``_stft_filters(kernel_size)`` already on the device."""
    K = kernel_size
    cutoff = K // 2 + 1
    filt = _filters_like(K, x, filters)
    y = F.conv1d(x[:, None, :], filt[:, None, :], stride=K // 2)
    return y[:, :cutoff, :], y[:, cutoff:, :]


def asteroid_istft(re: torch.Tensor, im: torch.Tensor, kernel_size: int,
                   length: int, filters=None) -> torch.Tensor:
    """(re, im) (B, F, N) -> (B, length): asteroid's decoder, the
    transposed filterbank with overlap-add at stride K/2 (tight frame, no
    NOLA division), zero-padded past its ``K + (K/2)(N-1)`` samples."""
    K = kernel_size
    spec = torch.cat([re, im], dim=1)  # (B, 2F, N)
    filt = _filters_like(K, spec, filters)
    y = F.conv_transpose1d(spec, filt[:, None, :], stride=K // 2)[:, 0]
    out_len = y.shape[-1]
    if out_len >= length:
        return y[:, :length]
    return F.pad(y, (0, length - out_len))


class ComplexConv(nn.Module):
    """asteroid ComplexConv2d / ComplexConvTranspose2d (a ``re_module`` /
    ``im_module`` pair): ``y = (conv_r(xr) - conv_i(xi), conv_r(xi) +
    conv_i(xr))``.

    Two forms of the same math, as in the JAX package: stacked (default),
    one ``2Cin -> 2Cout`` real conv with the block kernel ``[[wr, wi],
    [-wi, wr]]``; or ``gauss``, Gauss's three-multiplication form. The
    transposed form uses the weights as stored (torch tap order) with
    padding ``(k - 1) // 2``, which is the JAX package's flipped phase-split
    transpose cropped by ``(k - 1) // 2`` on each side."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=(1, 1),
                 transpose: bool = False, use_bias: bool = False,
                 gauss: bool = False):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = tuple((k - 1) // 2 for k in self.kernel)
        self.transpose = transpose
        self.use_bias = use_bias
        self.gauss = gauss
        cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.re_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)
        self.im_module = cls(in_ch, out_ch, self.kernel, self.stride,
                             self.padding, bias=use_bias)

    def _conv(self, v, w):
        if self.transpose:
            return F.conv_transpose2d(v, w, stride=self.stride,
                                      padding=self.padding)
        return F.conv2d(v, w, stride=self.stride, padding=self.padding)

    def forward(self, xr, xi):
        wr, wi = self.re_module.weight, self.im_module.weight
        if self.gauss:
            t1 = self._conv(xr, wr)
            t2 = self._conv(xi, wi)
            t3 = self._conv(xr + xi, wr + wi)
            yr, yi = t1 - t2, t3 - t1 - t2
        else:
            # Conv2d weights are (out, in, kh, kw), ConvTranspose2d's
            # (in, out, kh, kw): the block kernel stacks on the other axes
            o, i = (1, 0) if self.transpose else (0, 1)
            w = torch.cat([torch.cat([wr, -wi], dim=i),
                           torch.cat([wi, wr], dim=i)], dim=o)
            y = self._conv(torch.cat([xr, xi], dim=1), w)
            yr, yi = y.chunk(2, dim=1)
        if self.use_bias:
            br, bi = self.re_module.bias, self.im_module.bias
            yr = yr + (br - bi)[:, None, None]
            yi = yi + (br + bi)[:, None, None]
        return yr, yi


class OnReImBatchNorm(nn.Module):
    """norm_type "bN": independent BatchNorm on re and im (eps 1e-5;
    flax momentum 0.9 is torch momentum 0.1), trained as flax trains it
    (``models/batchnorm.py``: the biased variance in ``running_var``)."""

    def __init__(self, features: int):
        super().__init__()
        self.re_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.im_module = BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, xr, xi):
        return self.re_module(xr), self.im_module(xi)


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
        # inverse square root of the per-channel 2x2 covariance
        s = torch.sqrt(vrr * vii - vri * vri)
        t = torch.sqrt(vrr + vii + 2 * s)
        inv_st = 1.0 / (s * t)
        rrr, rii, rri = (vii + s) * inv_st, (vrr + s) * inv_st, -vri * inv_st
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
    """Complex conv -> norm -> leaky_relu(0.01) on (re, im)."""

    def __init__(self, args, norm_type: str, transpose: bool, gauss: bool):
        super().__init__()
        cin, cout, kernel, stride = args
        conv = ComplexConv(cin, cout, kernel, stride, transpose=transpose,
                           gauss=gauss)
        # asteroid's attribute names: "conv" in encoders, "deconv" in decoders
        self.conv_name = "deconv" if transpose else "conv"
        setattr(self, self.conv_name, conv)
        self.norm = _norm(norm_type, cout)

    def forward(self, xr, xi):
        xr, xi = self.norm(*getattr(self, self.conv_name)(xr, xi))
        return F.leaky_relu(xr, 0.01), F.leaky_relu(xi, 0.01)


class _Masker(nn.Module):
    """asteroid's DCUMaskNet over (re, im) (B, 1, F, N) -> the raw mask."""

    def __init__(self, stages, norm_type: str, gauss: bool,
                 identity_init: bool):
        super().__init__()
        self.encoders = nn.ModuleList(
            [_Block(s, norm_type, False, gauss) for s in stages])
        dec_args, (cin, cout, kernel, stride) = _decoder_args(stages)
        self.decoders = nn.ModuleList(
            [_Block(a, norm_type, True, gauss) for a in dec_args])
        self.output_layer = ComplexConv(cin, cout, kernel, stride,
                                        transpose=True, gauss=gauss)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform -> the same shape."""
        squeeze_ch = x.dim() == 3
        if squeeze_ch:
            x = x[:, 0, :]
        T_in = x.shape[-1]
        K = self.stft_kernel_size
        if T_in < K:  # asteroid pads so that one full frame exists
            x = F.pad(x, (0, K - T_in))
        re, im = asteroid_stft(x, K, self.filters)  # (B, F, N)
        F_full, N_in = re.shape[-2:]
        if (F_full - 1) % self.freq_prod:
            raise TypeError(
                f"freq axis {F_full} incompatible with architecture "
                f"{self.architecture} (needs (F-1) % {self.freq_prod} == 0); "
                "use a matching stft_kernel_size")
        pad_t = (-(N_in - 1)) % self.time_prod
        mr, mi = self.masker(F.pad(re, (0, pad_t))[:, None],
                             F.pad(im, (0, pad_t))[:, None])
        mr = mr[:, 0, :F_full, :N_in]
        mi = mi[:, 0, :F_full, :N_in]
        if self.identity_init:
            mr = mr + self.masker.mask_bias[0]
            mi = mi + self.masker.mask_bias[1]
        # bounded complex mask: tanh(|m|) * m / |m|
        mag = torch.sqrt(mr * mr + mi * mi + 1e-12)
        scale = torch.tanh(mag) / mag
        mr, mi = mr * scale, mi * scale
        yr = mr * re - mi * im
        yi = mr * im + mi * re
        y = asteroid_istft(yr, yi, K, T_in, self.filters)
        return y[:, None, :] if squeeze_ch else y

    def output_length(self, length: int) -> int:
        return length
