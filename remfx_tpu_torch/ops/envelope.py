"""Ballistics envelope follower: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``remfx_tpu/ops/pallas_env.py:envelope_pallas`` (the TPU
kernel ``_env_kernel``) and of its scan twin
``remfx_tpu/fx/compressor.py:envelope_scan``. Per row:

    env[t] = xa[t] + cte * (env[t-1] - xa[t]),   env[-1] = 0
    cte    = cte_at if xa[t] > env[t-1] else cte_rl

``envelope`` takes ``x_abs (B, T)`` and per-row ``cte_at``, ``cte_rl``
``(B,)``, all fp32 and contiguous. A CUDA tensor launches the split kernel
of ``csrc/envelope.cu`` (built by ``ops/_build.py``) or raises; a CPU
tensor takes ``envelope_plain``. There is no fallback from the card to the
plain version or to the serial kernel. ``envelope.launches`` counts the
split kernel's launches, one per call (three device kernels).

The split kernel. What bounds a kernel that walks time is the latency of
its longest chain of dependent steps; the serial kernel walks T steps in
one thread per row, on an almost empty card. Every step is monotone in
its carry, so two trajectories started at a lower and an upper bound of
the envelope (0 and the row maximum, for ``|x|``) enclose the true one,
and once they are bitwise equal they are the true one. Pass 0 finds the
bounds; pass 1 gives each (row, chunk of ``CHUNK`` samples) a thread that
starts both trajectories ``W`` samples before its chunk,
``W = ceil(WARM_TAU / (1 - max(cte_at, cte_rl)))`` rounded up to 32, and
runs the chunk from the upper one, flagging it unresolved when the two
had not met; pass 2 reruns each run of consecutive unresolved chunks, all
runs in parallel, from the exact value before it until it meets the
stored values. The result equals the serial kernel's bit for bit; the
slowest row sets the time, at about ``W + CHUNK`` steps of two
interleaved chains, unless a long run (digital silence after a hit) is
left to pass 2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from remfx_tpu_torch.ops import _build

_SOURCE = "envelope"
# kChunk and kWarmTau of csrc/envelope.cu, which the kernel compiles in
CHUNK = 1024  # samples a pass-1 thread owns
WARM_TAU = 20.0  # warm-up length W, in time constants 1 / (1 - cte)


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.remfx_envelope.argtypes = [ptr] * 6 + [i32, i64, ptr]
    lib.remfx_envelope_serial.argtypes = [ptr] * 4 + [i32, i64, ptr]
    lib.remfx_envelope.restype = lib.remfx_envelope_serial.restype = i32
    return lib


def _launch(fn, *args, device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"envelope kernel launch failed: CUDA error {err}")


def _on_card(x_abs: torch.Tensor) -> None:
    if x_abs.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {x_abs.device}")


def _split(x_abs, cte_at, cte_rl):
    _on_card(x_abs)
    rows, T = x_abs.shape
    out = torch.empty_like(x_abs)
    bounds = torch.empty(rows, 2, dtype=torch.float32, device=x_abs.device)
    unresolved = torch.empty(rows, -(-T // CHUNK), dtype=torch.uint8,
                             device=x_abs.device)
    _launch(_lib().remfx_envelope, x_abs.data_ptr(), cte_at.data_ptr(),
            cte_rl.data_ptr(), out.data_ptr(), bounds.data_ptr(),
            unresolved.data_ptr(), rows, T, device=x_abs.device)
    envelope.launches += 1
    return out, unresolved


def envelope(x_abs: torch.Tensor, cte_at: torch.Tensor,
             cte_rl: torch.Tensor) -> torch.Tensor:
    """Ballistics envelope over the last axis -> (B, T) fp32."""
    _check(x_abs, cte_at, cte_rl)
    if x_abs.device.type == "cpu":
        return envelope_plain(x_abs, cte_at, cte_rl)
    return _split(x_abs, cte_at, cte_rl)[0]


def envelope_flags(x_abs: torch.Tensor, cte_at: torch.Tensor,
                   cte_rl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The split kernel on CUDA tensors -> ``(env, unresolved)``, where
    ``unresolved (B, ceil(T / CHUNK))`` uint8 marks the chunks that pass 1
    left to pass 2, the chunks that pass 2 reran. Counts one launch in
    ``envelope.launches``; a CPU tensor raises (the chunks exist only in
    the kernel)."""
    _check(x_abs, cte_at, cte_rl)
    return _split(x_abs, cte_at, cte_rl)


def envelope_serial(x_abs: torch.Tensor, cte_at: torch.Tensor,
                    cte_rl: torch.Tensor) -> torch.Tensor:
    """The serial kernel (one thread walks each row), the oracle the split
    kernel is held to bit for bit; the main path does not call it. A CPU
    tensor takes ``envelope_plain``. ``envelope_serial.launches`` counts."""
    _check(x_abs, cte_at, cte_rl)
    if x_abs.device.type == "cpu":
        return envelope_plain(x_abs, cte_at, cte_rl)
    _on_card(x_abs)
    out = torch.empty_like(x_abs)
    rows, T = x_abs.shape
    _launch(_lib().remfx_envelope_serial, x_abs.data_ptr(), cte_at.data_ptr(),
            cte_rl.data_ptr(), out.data_ptr(), rows, T, device=x_abs.device)
    envelope_serial.launches += 1
    return out


envelope.launches = 0
envelope_serial.launches = 0
