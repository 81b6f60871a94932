"""The DCUNet's block epilogue: a block's complex norm, leaky ReLU and skip
concatenation on packed tensors. The CUDA kernel's wrapper and its plain
PyTorch version.

``models/dcunet.py``'s masker carries one tensor a block, ``(B,
packed_width(2C), H, W)``: the C real channels, then the C imaginary ones.
In eval it lies in ``torch.channels_last`` with zeros up to a multiple of 8
channels (cuDNN's NHWC kernels read 16 bytes of channels at a time and pad
any other count in a pass of their own); in train mode it is contiguous
with no zeros, because cuDNN's fp32 NHWC kernels are slower than its NCHW
ones. ``packed_layout`` reads which from the tensor. A block's convolution
writes it; this epilogue reads it once and applies, per complex channel c,

    yr = a[0, c] xr + a[1, c] xi + a[4, c]
    yi = a[2, c] xr + a[3, c] xi + a[5, c]

then the leaky ReLU, in fp32, rounded once to the input's type; in a
decoder it also copies the first ``skip_channels`` channels of the skip
after the block's 2C, the concatenation that feeds the next transposed
convolution; zeros fill a channels-last output up to a multiple of 8.
``coef`` fp32 is the norm (the norms' ``coefficients`` in
``models/dcunet.py``, from the running statistics in eval and the batch's
in train mode): ``(6, C)``, the full 2 x 2, for the complex whitening norm;
``(4, C)``, rows 0, 3, 4 and 5 with rows 1 and 2 zero, for a batch norm on
re and on im, so that the plain version leaves out the off-diagonal
products and their gradients.

``dcunet_epilogue`` decides which version runs, and no caller does: the
plain version, in torch ops, on the CPU and wherever autograd records
(grad mode on and ``x``, ``coef`` or ``skip`` requiring grad), so that it
carries the gradient; elsewhere ``csrc/dcunet_epilogue.cu`` (built by
``ops/_build.py``), which takes bf16 or fp32 activations and fp32
coefficients, contiguous in channels-last (the eval layout), on one card,
and raises on anything else: there is no fallback and no backward.
``dcunet_epilogue.launches`` counts the kernel's launches on the card; the
plain version adds nothing to it.

The kernel replaces no TPU kernel: the JAX package leaves the DCUNet's
norm, activation and concatenation to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from remfx_tpu_torch.ops import _build

_SOURCE = "dcunet_epilogue"
SLOPE = 0.01  # asteroid's leaky ReLU
PACK_BYTES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CL = torch.channels_last


def packed_width(channels: int, layout=CL) -> int:
    """Channels of a packed tensor that holds ``channels`` values a pixel:
    the next multiple of 8 channels-last, ``channels`` itself contiguous."""
    return -(-channels // 8) * 8 if layout == CL else channels


def packed_layout(x: torch.Tensor):
    """The layout of the packed tensor ``x``: contiguous (``packed_width``
    pads nothing), else channels-last."""
    return torch.contiguous_format if x.is_contiguous() else CL


def dcunet_epilogue_plain(x, coef, skip=None, skip_channels=0, slope=SLOPE):
    """x (B, >= 2C, H, W), coef (6, C) or (4, C) fp32 (or fp64), skip (B, >=
    skip_channels, H, W) or None -> (B, packed_width(2C + skip_channels), H,
    W) in ``x``'s dtype and packed layout: the affine of each (re, im) pair
    in the wider of the two types, the leaky ReLU, one rounding; then the
    skip's first channels as they are, then zeros. One ``split`` of ``x``
    and one ``cat``, so that autograd's backward copies each once."""
    C = coef.shape[1]
    a = dict(zip((0, 3, 4, 5) if len(coef) == 4 else range(6), coef.view(-1, 1, C, 1, 1)))
    xr, xi, _ = x.split([C, C, x.shape[1] - 2 * C], 1)

    def half(diag, off, bias, xd, xo):
        y = torch.addcmul(a[bias], xd, a[diag])
        if off in a:
            y = torch.addcmul(y, xo, a[off])
        return F.leaky_relu(y, slope).to(x.dtype)

    parts = [half(0, 1, 4, xr, xi), half(3, 2, 5, xi, xr)]
    if skip_channels:
        parts.append(skip[:, :skip_channels])
    layout = packed_layout(x)
    width = 2 * C + skip_channels
    pad = packed_width(width, layout) - width
    if pad:
        parts.append(torch.empty((x.shape[0], pad, *x.shape[2:]), dtype=x.dtype,
                                 device=x.device, memory_format=layout).zero_())
    return torch.cat(parts, 1).contiguous(memory_format=layout)


def recorded(*tensors) -> bool:
    """Whether autograd records an operation on ``tensors`` (None allowed):
    grad mode on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def dcunet_epilogue(x, coef, skip=None, skip_channels=0, slope=SLOPE):
    """``dcunet_epilogue_plain``'s function: that function on the CPU and
    where autograd records, the kernel elsewhere."""
    if x.device.type == "cpu" or recorded(x, coef, skip):
        return dcunet_epilogue_plain(x, coef, skip, skip_channels, slope)
    return _fused(x, coef, skip, skip_channels, slope)


dcunet_epilogue.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.remfx_dcunet_epilogue.argtypes = [ptr] * 4 + [i32, i32, i64] + [i32] * 5 + [
        ctypes.c_float, ptr]
    lib.remfx_dcunet_epilogue.restype = i32
    return lib


def _check_fused(x, coef, skip, skip_channels):
    if x.device.type != "cuda":
        raise ValueError(f"no dcunet_epilogue kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the dcunet_epilogue kernel takes float32 or bfloat16, got {x.dtype}")
    if recorded(x, coef, skip):
        raise ValueError("the dcunet_epilogue kernel has no backward pass")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, channels, H, W), got shape {tuple(x.shape)}")
    C = coef.shape[-1]
    if coef.dtype != torch.float32 or coef.device != x.device:
        raise TypeError(f"coef is {coef.dtype} on {coef.device}: float32 on {x.device} wanted")
    if (tuple(coef.shape) != (6, C) or not coef.is_contiguous() or x.shape[1] < 2 * C
            or x.shape[1] % 2):
        raise ValueError(f"coef {tuple(coef.shape)} (contiguous) for x {tuple(x.shape)} "
                         "(an even count of channels, 2C or more)")
    if not x.is_contiguous(memory_format=CL):
        raise ValueError("x must be contiguous in channels-last")
    if (skip is None) != (skip_channels == 0):
        raise ValueError("skip and skip_channels go together")
    if skip is not None:
        if skip.dtype != x.dtype or skip.device != x.device:
            raise TypeError(f"skip is {skip.dtype} on {skip.device}, x {x.dtype} on {x.device}")
        if (skip.dim() != 4 or skip.shape[1] % 2 or skip_channels % 2
                or not 0 < skip_channels <= skip.shape[1]
                or skip.shape[0] != x.shape[0] or skip.shape[2:] != x.shape[2:]):
            raise ValueError(f"skip {tuple(skip.shape)} ({skip_channels} channels) "
                             f"for x {tuple(x.shape)}")
        if not skip.is_contiguous(memory_format=CL):
            raise ValueError("skip must be contiguous in channels-last")


def _fused(x, coef, skip, skip_channels, slope):
    """One launch of the kernel -> (B, packed_width(2C + skip_channels), H,
    W) channels-last."""
    if coef.dim() == 2 and len(coef) == 4:  # the kernel reads the 2 x 2 in full
        full = coef.new_zeros((6, coef.shape[1]))
        full[0], full[3:] = coef[0], coef[1:]
        coef = full
    _check_fused(x, coef, skip, skip_channels)
    C = coef.shape[1]
    ow = packed_width(2 * C + skip_channels)
    out = torch.empty((x.shape[0], ow, *x.shape[2:]), dtype=x.dtype, device=x.device,
                      memory_format=CL)
    pixels = x.shape[0] * x.shape[2] * x.shape[3]
    if pixels == 0:
        return out
    vec = all(t.data_ptr() % PACK_BYTES == 0 for t in (x, skip, out) if t is not None)
    sw = 0 if skip is None else skip.shape[1]
    with torch.cuda.device(x.device):
        err = _lib().remfx_dcunet_epilogue(
            x.data_ptr(), None if skip is None else skip.data_ptr(), coef.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], int(vec), pixels, C, x.shape[1],
            skip_channels, sw, ow, slope, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcunet_epilogue kernel launch failed: CUDA error {err}")
    dcunet_epilogue.launches += 1
    return out
