"""The DCUNet's eval epilogue: a block's complex norm, leaky ReLU and skip
concatenation on packed channels-last tensors. The CUDA kernel's wrapper
and its plain PyTorch version.

In eval, ``models/dcunet.py``'s masker carries one tensor a block, ``(B,
packed_width(2C), H, W)`` in ``torch.channels_last``: the C real channels,
the C imaginary ones, then zeros up to a multiple of 8 channels (cuDNN's
NHWC kernels read 16 bytes of channels at a time and pad any other count
in a pass of their own). A block's convolution writes it; this epilogue
reads it once and applies, per complex channel c,

    yr = a[0, c] xr + a[1, c] xi + a[4, c]
    yi = a[2, c] xr + a[3, c] xi + a[5, c]

then the leaky ReLU, in fp32, rounded once to the input's type; in a
decoder it also copies the first ``skip_channels`` channels of the skip
after the block's 2C, the concatenation that feeds the next transposed
convolution; zeros fill the output up to a multiple of 8. ``coef`` ``(6,
C)`` fp32 is the eval norm: a batch norm on re and on im is the diagonal
case, the complex whitening norm the full 2 x 2 (the norms'
``eval_affine`` in ``models/dcunet.py``).

``dcunet_epilogue_plain`` is the same math in torch ops: the path of CPU
tensors. Every other call launches ``csrc/dcunet_epilogue.cu`` (built by
``ops/_build.py``) or raises: bf16 or fp32 activations, fp32
coefficients, contiguous in channels-last, on one card. There is no
fallback and no backward: the masker takes this path only where autograd
records nothing. ``dcunet_epilogue.launches`` counts the kernel's
launches on the card; the CPU path adds nothing to it.

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


def packed_width(channels: int) -> int:
    """Channels of a packed tensor that holds ``channels`` values a pixel:
    the next multiple of 8."""
    return -(-channels // 8) * 8


def dcunet_epilogue_plain(x, coef, skip=None, skip_channels=0, slope=SLOPE):
    """x (B, >= 2C, H, W), coef (6, C) fp32, skip (B, >= skip_channels, H,
    W) or None -> (B, packed_width(2C + skip_channels), H, W) channels-last
    in ``x``'s dtype: the affine of each (re, im) pair in fp32, the leaky
    ReLU, one rounding; then the skip's first channels as they are, then
    zeros."""
    C = coef.shape[1]
    a = coef.view(6, 1, C, 1, 1)
    xr, xi = x[:, :C].float(), x[:, C:2 * C].float()
    width = 2 * C + skip_channels
    out = torch.empty((x.shape[0], packed_width(width), *x.shape[2:]), dtype=x.dtype,
                      device=x.device, memory_format=CL)
    out[:, :C] = F.leaky_relu(xr * a[0] + xi * a[1] + a[4], slope)
    out[:, C:2 * C] = F.leaky_relu(xr * a[2] + xi * a[3] + a[5], slope)
    if skip_channels:
        out[:, 2 * C:width] = skip[:, :skip_channels]
    out[:, width:] = 0
    return out


def dcunet_epilogue(x, coef, skip=None, skip_channels=0, slope=SLOPE):
    """``dcunet_epilogue_plain``'s function: on the CPU that function, on
    the card the kernel (no autograd)."""
    if x.device.type == "cpu":
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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, coef, skip)):
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
