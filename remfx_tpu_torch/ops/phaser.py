"""The phaser's recurrence: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of the ``lax.scan`` of ``remfx_tpu/fx/phaser.py:_render``
(``:75-94``); the JAX package has no Pallas kernel for it. Per row (example
b, channel c) and sample t, with the per-sample coefficient ``a (B, T)``
shared by the channels of an example:

    u      = x[t] + feedback * last
    y_s    = a * u_s + xs[s] - a * ys[s],   u_0 = u, u_{s+1} = y_s, s < 6
    out[t] = (1 - mix) * x[t] + mix * y_5

``phaser`` takes ``x (B, C, T)``, ``a (B, T)`` and per-example ``feedback``,
``mix`` ``(B,)``, all fp32 and contiguous. A CUDA tensor launches the
kernel of ``csrc/phaser.cu`` (built by ``ops/_build.py``) or raises; a CPU
tensor takes ``phaser_plain``. There is no fallback from the card to the
plain version. ``phaser.launches`` counts the kernel's launches, one per
call.

The kernel rounds every product and sum to nearest in the plain version's
order, with no fused multiply-add, so the two agree bit for bit on the same
``a``. The coefficient itself (sines, exponentials, a tangent) is computed
by the caller in PyTorch (``fx/phaser.py:coefficients``), and differs by
ulps between the card and the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from remfx_tpu_torch.ops import _build

_SOURCE = "phaser"
N_STAGES = 6


def phaser_plain(x: torch.Tensor, a: torch.Tensor, feedback: torch.Tensor,
                 mix: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over time, vectorised across rows."""
    xt = x.permute(2, 0, 1).contiguous()  # (T, B, C): each step reads one sample
    at = a.t().contiguous()[:, :, None]  # (T, B, 1)
    fb = feedback[:, None]
    xs = [torch.zeros_like(xt[0]) for _ in range(N_STAGES)]
    ys = [torch.zeros_like(xt[0]) for _ in range(N_STAGES)]
    last = torch.zeros_like(xt[0])
    wet = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        a_t = at[t]
        u = xt[t] + fb * last
        for s in range(N_STAGES):
            y = a_t * u + xs[s] - a_t * ys[s]
            xs[s] = u
            ys[s] = y
            u = y
        last = u
        wet[t] = u
    m = mix[:, None, None]
    return (1.0 - m) * x + m * wet.permute(1, 2, 0)


def _check(x, a, feedback, mix):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got shape {tuple(x.shape)}")
    B, _, T = x.shape
    want = {"a": (B, T), "feedback": (B,), "mix": (B,)}
    for name, t in (("x", x), ("a", a), ("feedback", feedback), ("mix", mix)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.remfx_phaser.argtypes = [ptr] * 5 + [i32, i32, i64, ptr]
    lib.remfx_phaser.restype = i32
    return lib


def phaser(x: torch.Tensor, a: torch.Tensor, feedback: torch.Tensor,
           mix: torch.Tensor) -> torch.Tensor:
    """The phaser over the last axis -> (B, C, T) fp32."""
    _check(x, a, feedback, mix)
    if x.device.type == "cpu":
        return phaser_plain(x, a, feedback, mix)
    if x.device.type != "cuda":
        raise ValueError(f"no phaser kernel for device {x.device}")
    B, C, T = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().remfx_phaser(
            x.data_ptr(), a.data_ptr(), feedback.data_ptr(), mix.data_ptr(),
            out.data_ptr(), B, C, T, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"phaser kernel launch failed: CUDA error {err}")
    phaser.launches += 1
    return out


phaser.launches = 0
