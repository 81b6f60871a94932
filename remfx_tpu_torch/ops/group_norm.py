"""GroupNorm fused with the activation after it: the CUDA kernel's wrapper,
its backward pass and its plain PyTorch version.

HDemucs (``models/demucs.py``) normalises with ``GroupNorm`` and then, in
the same breath, applies one of: the exact-erf GELU, the GLU over the
channel halves, or (the second norm of a ``DConv`` depth) the GLU, the
LayerScale and the residual add, ``residual + scale[c] * glu``.
``group_norm`` takes that whole step: ``act`` is ``"gelu"`` or ``"glu"``,
and ``residual``/``scale`` (both or neither, with ``"glu"`` only) add the
rest.

``group_norm_plain`` is the composition torch runs, ``F.group_norm`` then
the activation, then ``residual + scale[:, None...] * y``: the path of CPU
tensors. Every other call launches ``csrc/group_norm.cu`` (built by
``ops/_build.py``) or raises: bf16 or fp32, every tensor of that type,
contiguous and on the same card. There is no fallback. Where autograd
records the call (grad mode on and an input or parameter that requires
grad), the kernel also writes each group's mean and rstd, and the backward
pass (``group_norm_backward``) takes the epilogue's gradient through torch's
GELU / GLU on the normalised input recomputed from them, then torch's
``native_group_norm_backward``, the kernel of ``nn.GroupNorm``'s own
backward, fed the kernel's statistics. ``group_norm.launches`` counts the
kernel's calls (two device kernels each); every call, on either path, is the
span ``groupnorm``.

The kernel replaces no TPU kernel: the JAX package leaves GroupNorm to XLA.
It computes the statistics and the epilogue in fp32 and rounds once, where
torch's composition rounds after the norm and after each epilogue step; its
partial moments combine in a fixed order, so a call repeats bit for bit.
``chunks`` is the statistics pass's split of each (row, group), chosen from
the shape alone.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from remfx_tpu_torch.ops import _build
from remfx_tpu_torch.utils.spans import span

_SOURCE = "group_norm"
ACTS = {"gelu": 0, "glu": 1}  # the kernel's codes (enum Act); 2: GLU, LayerScale, residual
GLU_RESIDUAL = 2
THREADS = 256  # a block's threads (kThreads of csrc/group_norm.cu)
MIN_PACKS = 4  # packs a thread of the statistics pass reads at least (kMinPacks)
# blocks the statistics pass aims for: the H100's 132 SMs, 8 blocks each
TARGET_BLOCKS = 132 * 8
PACK_BYTES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunks(groups: int, packs: int) -> int:
    """Chunks each of ``groups`` (rows x groups) is cut into for the
    statistics pass, ``packs`` 16-byte packs (or elements, unvectorised)
    each: enough to give ``TARGET_BLOCKS`` blocks in all, but no chunk so
    short that a thread reads fewer than ``MIN_PACKS`` packs; 1 where the
    groups alone fill the card. Chunks are ``ceil(packs / chunks)`` long,
    and none is empty."""
    k = min(-(-TARGET_BLOCKS // groups), max(1, packs // (THREADS * MIN_PACKS)))
    return -(-packs // -(-packs // k))


def _epilogue(y, act, residual, scale):
    """``act`` of the normalised ``y``, then ``residual + scale * act(y)``."""
    y = F.gelu(y) if act == "gelu" else F.glu(y, 1)
    if scale is not None:
        y = scale.view(-1, *([1] * (y.dim() - 2))) * y
    return y if residual is None else residual + y


def group_norm_plain(x, groups, weight, bias, eps=1e-5, act="gelu", residual=None,
                     scale=None):
    """torch's ``F.group_norm``, then ``act``, then ``residual + scale * y``."""
    return _epilogue(F.group_norm(x, groups, weight, bias, eps), act, residual, scale)


def _check_args(act, residual, scale):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if (residual is None) != (scale is None) or (residual is not None and act != "glu"):
        raise ValueError("residual and scale go together, with act='glu' only")


def _wants_grad(*tensors) -> bool:
    """Whether autograd records this call: grad mode on and some input
    requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def group_norm(x, groups, weight, bias, eps=1e-5, act="gelu", residual=None, scale=None):
    """GroupNorm of ``x`` (N, C, *) with ``groups`` groups and the affine
    ``weight``, ``bias`` (C,), then ``act``; with ``residual`` (N, C/2, *)
    and ``scale`` (C/2,), ``residual + scale * glu``. -> (N, C or C/2, *) in
    ``x``'s dtype; on the card the fused kernel, differentiable."""
    _check_args(act, residual, scale)
    with span("groupnorm"):
        if x.device.type == "cpu":
            return group_norm_plain(x, groups, weight, bias, eps, act, residual, scale)
        if _wants_grad(x, weight, bias, residual, scale):
            return _GroupNormAct.apply(x, weight, bias, residual, scale, groups, eps, act)
        return _fused(x, groups, weight, bias, eps, act, residual, scale)[0]


def group_norm_backward(grad, x, groups, weight, bias, mean, rstd, act, scale, needs):
    """Gradients of ``group_norm`` for ``(x, weight, bias, residual, scale)``
    (None where ``needs`` says none is wanted) from the output's gradient and
    the forward's fp32 ``mean``, ``rstd`` (N, groups). The normalised input
    is recomputed from them, the epilogue differentiated by autograd through
    torch's GELU / GLU (and LayerScale), and the norm by torch's
    ``native_group_norm_backward``, given the statistics in ``x``'s dtype as
    ``nn.GroupNorm``'s forward would have saved them (and contiguous: it
    reads them as such)."""
    N, C = x.shape[:2]
    S = math.prod(x.shape[2:])
    per = C // groups
    a = rstd.repeat_interleave(per, 1) * weight.float()  # (N, C)
    b = bias.float() - mean.repeat_interleave(per, 1) * a
    at = (N, C) + (1,) * (x.dim() - 2)
    y = torch.addcmul(b.view(at), x, a.view(at)).to(x.dtype)
    with torch.enable_grad():
        y.requires_grad_()
        s = None if scale is None else scale.detach().requires_grad_(needs[4])
        out = _epilogue(y, act, None, s)
        wrt = [y] + ([s] if needs[4] else [])
        dy, *dscale = torch.autograd.grad(out, wrt, grad)
    dx = dw = db = None
    if any(needs[:3]):
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            dy.contiguous(), x, mean.to(x.dtype).contiguous(), rstd.to(x.dtype).contiguous(),
            weight, N, C, S, groups, list(needs[:3]))
    return dx, dw, db, grad if needs[3] else None, dscale[0] if dscale else None


class _GroupNormAct(torch.autograd.Function):
    """The kernel's forward, with each group's statistics saved for
    ``group_norm_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, scale, groups, eps, act):
        out, stats = _fused(x, groups, weight, bias, eps, act, residual, scale, stats=True)
        ctx.save_for_backward(x, weight, bias, scale, stats)
        ctx.groups, ctx.act = groups, act
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, weight, bias, scale, stats = ctx.saved_tensors
        grads = group_norm_backward(grad, x, ctx.groups, weight, bias, stats[..., 0],
                                    stats[..., 1], ctx.act, scale, ctx.needs_input_grad[:5])
        return (*grads, None, None, None)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.remfx_group_norm.argtypes = ([ptr] * 8 + [i32, i32, i32, i64, i32, i32, i32, i32,
                                                  ctypes.c_float, ptr])
    lib.remfx_group_norm.restype = i32
    return lib


def _check_fused(x, groups, weight, bias, act, residual, scale):
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"x must be (N, C, *), got shape {tuple(x.shape)}")
    C = x.shape[1]
    if groups <= 0 or C % groups or (act == "glu" and C % 2):
        raise ValueError(f"{C} channels in {groups} groups{' halved' * (act == 'glu')}")
    half = list(x.shape)
    half[1] = C // 2
    for name, t, shape in (("x", x, list(x.shape)), ("weight", weight, [C]),
                           ("bias", bias, [C]), ("residual", residual, half),
                           ("scale", scale, [C // 2])):
        if t is None and name in ("residual", "scale"):
            continue
        if t is None:
            raise ValueError(f"the group_norm kernel needs the affine {name}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, x {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if list(t.shape) != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    row = math.prod(x.shape[1:])
    if row >= 2**31 or 2 * groups * 4 > 48 * 1024:
        raise ValueError(f"no group_norm kernel for rows of {row} elements in {groups} groups")


def _fused(x, groups, weight, bias, eps, act, residual, scale, stats=False):
    """One launch of the kernel -> the output and, with ``stats``, each
    group's (mean, rstd) in fp32, (N, groups, 2); else None."""
    _check_fused(x, groups, weight, bias, act, residual, scale)
    N, C = x.shape[:2]
    S = math.prod(x.shape[2:])
    out_shape = (N, C // 2, *x.shape[2:]) if act == "glu" else tuple(x.shape)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    moments = (torch.empty(N, groups, 2, dtype=torch.float32, device=x.device) if stats
               else None)
    if out.numel() == 0:
        return out, moments
    pack = PACK_BYTES // x.element_size()
    vec = S % pack == 0 and all(t.data_ptr() % PACK_BYTES == 0
                                for t in (x, out, residual) if t is not None)
    k = chunks(N * groups, C // groups * S // (pack if vec else 1))
    part = torch.empty(N * groups * k * 2, dtype=torch.float32, device=x.device)
    code = GLU_RESIDUAL if residual is not None else ACTS[act]
    with torch.cuda.device(x.device):
        err = _lib().remfx_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), part.data_ptr(),
            None if moments is None else moments.data_ptr(), _DTYPES[x.dtype], int(vec), code,
            N, groups, C, S, k, eps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {err}")
    group_norm.launches += 1
    return out, moments


group_norm.launches = 0
