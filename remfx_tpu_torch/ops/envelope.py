"""Ballistics envelope follower: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``remfx_tpu/ops/pallas_env.py:envelope_pallas`` (the TPU
kernel ``_env_kernel``) and of its scan twin
``remfx_tpu/fx/compressor.py:envelope_scan``. Per row:

    env[t] = xa[t] + cte * (env[t-1] - xa[t]),   env[-1] = 0
    cte    = cte_at if xa[t] > env[t-1] else cte_rl

``envelope`` takes ``x_abs (B, T)`` and per-row ``cte_at``, ``cte_rl``
``(B,)``, all fp32 and contiguous. A CUDA tensor launches the kernel of
``csrc/envelope.cu`` (built by ``ops/_build.py``) or raises; a CPU tensor
takes ``envelope_plain``. There is no fallback from the card to the plain
version. ``envelope.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from remfx_tpu_torch.ops import _build

_SOURCE = "envelope"


def envelope_plain(x_abs: torch.Tensor, cte_at: torch.Tensor,
                   cte_rl: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over time, vectorised across rows."""
    xt = x_abs.t().contiguous()  # (T, B): each step reads one row
    out = torch.empty_like(xt)
    env = torch.zeros_like(xt[0])
    for t in range(xt.shape[0]):
        xa = xt[t]
        cte = torch.where(xa > env, cte_at, cte_rl)
        env = xa + cte * (env - xa)
        out[t] = env
    return out.t().contiguous()


def _check(x_abs, cte_at, cte_rl):
    if x_abs.dim() != 2:
        raise ValueError(f"x_abs must be (B, T), got shape {tuple(x_abs.shape)}")
    rows = x_abs.shape[0]
    for name, t in (("x_abs", x_abs), ("cte_at", cte_at), ("cte_rl", cte_rl)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_abs.device:
            raise ValueError(f"{name} is on {t.device}, x_abs on {x_abs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("cte_at", cte_at), ("cte_rl", cte_rl)):
        if tuple(t.shape) != (rows,):
            raise ValueError(f"{name} must be ({rows},), got {tuple(t.shape)}")


def envelope(x_abs: torch.Tensor, cte_at: torch.Tensor,
             cte_rl: torch.Tensor) -> torch.Tensor:
    """Ballistics envelope over the last axis -> (B, T) fp32."""
    _check(x_abs, cte_at, cte_rl)
    if x_abs.device.type == "cpu":
        return envelope_plain(x_abs, cte_at, cte_rl)
    if x_abs.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {x_abs.device}")
    lib = _build.load(_SOURCE)
    fn = lib.remfx_envelope
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x_abs)
    rows, T = x_abs.shape
    with torch.cuda.device(x_abs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_abs.data_ptr(), cte_at.data_ptr(), cte_rl.data_ptr(),
                 out.data_ptr(), rows, T, stream)
    if err != 0:
        raise RuntimeError(f"envelope kernel launch failed: CUDA error {err}")
    envelope.launches += 1
    return out


envelope.launches = 0
