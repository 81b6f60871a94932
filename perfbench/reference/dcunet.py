"""The plain fp32 DCUNet of the benchmark's reference: asteroid's
``DCUNet("Large-DCUNet-20", stft_kernel_size=512, fix_length_mode="pad")``
as the RemFX reference builds it (remfx/models.py:347-367 of
https://github.com/mhrice/RemFX).

Written from asteroid's published structure (``DCUNetComplexEncoderBlock``
/ ``DCUNetComplexDecoderBlock``, the complex wrappers of ``complex_nn``),
with asteroid's state-dict names (``masker.encoders.{i}.conv.re_module``,
``masker.decoders.{i}.deconv``, ``masker.output_layer``): the skip is
concatenated after each decoder, the mask is ``tanh(|m|) m / |m|``, and
the time frames are zero-padded so that ``(N - 1) % prod(time strides)
== 0`` ("pad"). Complex tensors throughout, where the program carries
real and imaginary parts apart.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# asteroid's Large-DCUNet-20 encoder: (in, out, kernel (F, T), stride (F, T))
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
ARCHITECTURES = {"Large-DCUNet-20": LARGE_DCUNET_20}


class ComplexMultiplicationWrapper(nn.Module):
    def __init__(self, module_cls, *args, **kwargs):
        super().__init__()
        self.re_module = module_cls(*args, **kwargs)
        self.im_module = module_cls(*args, **kwargs)

    def forward(self, x):
        return torch.complex(
            self.re_module(x.real) - self.im_module(x.imag),
            self.re_module(x.imag) + self.im_module(x.real),
        )


class OnReIm(nn.Module):
    def __init__(self, module_cls, *args, **kwargs):
        super().__init__()
        self.re_module = module_cls(*args, **kwargs)
        self.im_module = module_cls(*args, **kwargs)

    def forward(self, x):
        return torch.complex(self.re_module(x.real), self.im_module(x.imag))


def _norm(norm_type, C):
    if norm_type == "bN":
        return OnReIm(nn.BatchNorm2d, C)
    raise ValueError(f"norm_type {norm_type!r}: the reference has only 'bN'")


class EncoderBlock(nn.Module):
    def __init__(self, in_chan, out_chan, kernel, stride, norm_type):
        super().__init__()
        pad = tuple((k - 1) // 2 for k in kernel)
        self.conv = ComplexMultiplicationWrapper(
            nn.Conv2d, in_chan, out_chan, kernel, stride, pad, bias=False)
        self.norm = _norm(norm_type, out_chan)
        self.act = OnReIm(nn.LeakyReLU, 0.01)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class DecoderBlock(nn.Module):
    def __init__(self, in_chan, out_chan, kernel, stride, norm_type):
        super().__init__()
        pad = tuple((k - 1) // 2 for k in kernel)
        self.deconv = ComplexMultiplicationWrapper(
            nn.ConvTranspose2d, in_chan, out_chan, kernel, stride, pad,
            bias=False)
        self.norm = _norm(norm_type, out_chan)
        self.act = OnReIm(nn.LeakyReLU, 0.01)

    def forward(self, x):
        return self.act(self.norm(self.deconv(x)))


class Masker(nn.Module):
    """asteroid DCUMaskNet graph over complex (B, 1, F, T)."""

    def __init__(self, stages, norm_type="bN"):
        super().__init__()
        self.stages = stages
        self.encoders = nn.ModuleList([
            EncoderBlock(cin, cout, k, s, norm_type)
            for cin, cout, k, s in stages
        ])
        dec_args = []
        for j, (cin, cout, kernel, stride) in enumerate(reversed(stages)):
            skip = cout if dec_args else 0
            dec_args.append((cout + skip, cin, kernel, stride))
        self.decoders = nn.ModuleList([
            DecoderBlock(*args, norm_type) for args in dec_args[:-1]
        ])
        cin, cout, kernel, stride = dec_args[-1]
        pad = tuple((k - 1) // 2 for k in kernel)
        self.output_layer = ComplexMultiplicationWrapper(
            nn.ConvTranspose2d, cin, cout, kernel, stride, pad, bias=False)
        self.time_prod = int(np.prod([s[3][1] for s in stages]))

    def forward(self, x):
        # x complex (B, 1, F, T); fix_input_dims 'pad'
        N_in = x.shape[-1]
        pad_t = (-(N_in - 1)) % self.time_prod
        x = torch.nn.functional.pad(x, (0, pad_t))
        enc_outs = []
        for enc in self.encoders:
            x = enc(x)
            enc_outs.append(x)
        for enc_out, dec in zip(reversed(enc_outs[:-1]), self.decoders):
            x = dec(x)
            x = torch.cat([x, enc_out], dim=1)
        m = self.output_layer(x)[..., :N_in]
        mag = (m.real**2 + m.imag**2 + 1e-12).sqrt()
        scale = torch.tanh(mag) / mag
        return torch.complex(m.real * scale, m.imag * scale)


def stft_filters(kernel_size: int) -> np.ndarray:
    """asteroid's STFTFB filters ``(2 * (K // 2 + 1), K)``: the DFT rows
    under a sqrt periodic Hann window, scaled to a tight frame at hop K / 2,
    the DC and Nyquist rows divided by sqrt 2; float64, rounded once."""
    K = kernel_size
    cutoff = K // 2 + 1
    window = np.hanning(K + 1)[:-1] ** 0.5
    f = np.fft.fft(np.eye(K)) / (0.5 * np.sqrt(K * K / (K // 2)))
    filters = np.concatenate([np.real(f[:cutoff]), np.imag(f[:cutoff])])
    filters[0, :] /= np.sqrt(2)
    filters[K // 2, :] /= np.sqrt(2)
    return (filters * window[None, :]).astype(np.float32)


class DCUNet(nn.Module):
    """The whole model: asteroid's STFT encoder (a framing convolution),
    the masker, the bounded mask on the input's STFT, and the decoder (the
    transposed framing convolution). (B, 1, T) -> (B, 1, T)."""

    def __init__(self, architecture="Large-DCUNet-20", stft_kernel_size=512,
                 norm_type="bN"):
        super().__init__()
        self.kernel_size = stft_kernel_size
        self.masker = Masker(ARCHITECTURES[architecture], norm_type)
        self.register_buffer("filters", torch.tensor(stft_filters(stft_kernel_size)),
                             persistent=False)

    def forward(self, wav):
        K = self.kernel_size
        cutoff = K // 2 + 1
        wav = wav[:, 0]
        T_in = wav.shape[-1]
        if T_in < K:  # asteroid pads so that one full frame exists
            wav = torch.nn.functional.pad(wav, (0, K - T_in))
        spec = torch.nn.functional.conv1d(
            wav[:, None, :], self.filters[:, None, :], stride=K // 2)
        z = torch.complex(spec[:, :cutoff], spec[:, cutoff:])
        mask = self.masker(z[:, None])[:, 0]
        y = z * mask
        spec_out = torch.cat([y.real, y.imag], dim=1)
        out = torch.nn.functional.conv_transpose1d(
            spec_out, self.filters[:, None, :], stride=K // 2)[:, 0]
        if out.shape[-1] >= T_in:
            return out[:, None, :T_in]
        return torch.nn.functional.pad(out, (0, T_in - out.shape[-1]))[:, None]
