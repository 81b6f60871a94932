"""The phaser's recurrence: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of the ``lax.scan`` of ``remfx_tpu/fx/phaser.py:_render``
(``:75-94``); the JAX package has no Pallas kernel for it. Per row (example
b, channel c) and sample t, with the per-sample coefficient ``a (B, T)``
shared by the channels of an example:

    u      = x[t] + feedback * last
    y_s    = a * u_s + xs[s] - a * ys[s],   u_0 = u, u_{s+1} = y_s, s < 6
    out[t] = (1 - mix) * x[t] + mix * y_5

``phaser`` takes ``x (B, C, T)``, ``a (B, T)`` and per-example ``feedback``,
``mix`` ``(B,)``, all fp32 and contiguous. A CUDA tensor launches the split
kernel of ``csrc/phaser.cu`` (built by ``ops/_build.py``) or raises; a CPU
tensor takes ``phaser_plain``. There is no fallback from the card to the
serial kernel or to the plain version. ``phaser.launches`` counts one per
call (three device kernels).

The split kernel. Of the 13 state floats 7 are independent (after a step
``ys[s] = xs[s + 1]`` and ``last = ys[5]``), and a step is affine in them:
chunks of ``CHUNK`` samples map the state at their start to ``Phi s + p``.
Pass 1 walks every chunk at once from the zero state and from the 7 unit
states, and composes the maps of each warp's 32 chunks into prefix maps;
pass 2 scans each row's groups of 32 chunks in order; pass 3 reruns every
chunk from its exact start. ``phaser_chunked_plain`` models the three
passes in PyTorch, vectorised over chunks, for the CPU tests; nothing on a
path with a card calls it. The maps round in another order than the walk,
so the split kernel is held to ``phaser_plain`` within ``SPLIT_TOL`` of each
row's peak, not bit for bit.

The serial kernel (``phaser_serial``: one thread walks each row) rounds
every product and sum to nearest in the plain version's order, with no fused
multiply-add, so it equals ``phaser_plain`` bit for bit on the same ``a``;
it is the split kernel's oracle on the card. The coefficient itself (sines,
exponentials, a tangent) is computed by the caller in PyTorch
(``fx/phaser.py:coefficients``), and differs by ulps between the card and
the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from remfx_tpu_torch.ops import _build

_SOURCE = "phaser"
N_STAGES = 6
STATE = N_STAGES + 1  # the independent state floats, u_0..u_6
GROUP = 32  # chunks a warp composes (kWarp of csrc/phaser.cu)
_MAP = STATE * STATE + STATE  # floats of a stored map (kMap)
_START = 8  # floats of a stored state (kStart)
CHUNK = 128  # samples a thread of passes 1 and 3 walks (kChunk: which and why)
# The split kernel against phaser_plain, of each row's peak: at most 2.4e-6
# measured on the H100 and 2.1e-6 in the chunked plain model at 8 x 2 x
# 262144 on the slowest poles, where the serial walk's own fp32 rounding is
# about 1e-6 from float64.
SPLIT_TOL = 1e-5


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


def _step(v: list, a, fb, x):
    """One sample on the 7-float state ``v`` (a list, updated in place), in
    the split kernel's form: ``u_{s+1} = a * u_s + (v_s - a * v_{s+1})``."""
    u = fb * v[STATE - 1] + x
    for k in range(N_STAGES):
        w = v[k] - a * v[k + 1]
        v[k] = u
        u = a * u + w
    v[STATE - 1] = u
    return u


def phaser_chunked_plain(x: torch.Tensor, a: torch.Tensor, feedback: torch.Tensor,
                         mix: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The split kernel's three passes, vectorised over chunks: the model of
    its numerics for the CPU tests (not its rounding: the kernel fuses
    products into FMAs). Chunks past the row's end are zero, as the
    kernel reads them."""
    B, C, T = x.shape
    rows, n = B * C, -(-T // chunk)
    groups = -(-n // GROUP)
    pad = groups * GROUP * chunk - T
    xr = F.pad(x.reshape(rows, T), (0, pad)).reshape(rows, groups * GROUP, chunk)
    ar = F.pad(a, (0, pad)).repeat_interleave(C, dim=0).reshape(xr.shape)
    fb = feedback.repeat_interleave(C)[:, None, None]
    # pass 1: chains 0..6 from the unit states with no input, 7 from zero
    units = torch.eye(STATE, STATE + 1, dtype=x.dtype)
    v = [units[k].expand(*xr.shape[:2], STATE + 1).clone() for k in range(STATE)]
    only_7 = units.new_zeros(STATE + 1)
    only_7[STATE] = 1.0
    for t in range(chunk):
        _step(v, ar[..., t, None], fb, xr[..., t, None] * only_7)
    ends = torch.stack(v, dim=-2)  # (rows, chunks, 7, 8): [u_i, chain]
    A = ends[..., :STATE].reshape(rows, groups, GROUP, STATE, STATE)
    c = ends[..., STATE].reshape(rows, groups, GROUP, STATE)
    # the prefix maps within each group, Hillis-Steele as the warp scans:
    # lane j >= off takes (A, c) o (lane j - off's)
    off = 1
    while off < GROUP:
        later = torch.arange(GROUP) >= off
        eA = torch.cat([A[:, :, :off], A[:, :, :-off]], dim=2)
        ec = torch.cat([c[:, :, :off], c[:, :, :-off]], dim=2)
        c = torch.where(later[:, None], (A @ ec[..., None])[..., 0] + c, c)
        A = torch.where(later[:, None, None], A @ eA, A)
        off *= 2
    # pass 2: each group's start, through the groups' whole maps in order
    s = x.new_zeros(rows, STATE)
    starts = []
    for g in range(groups):
        starts.append(s)
        s = (A[:, g, -1] @ s[..., None])[..., 0] + c[:, g, -1]
    s0 = torch.stack(starts, dim=1)  # (rows, groups, 7)
    # pass 3: each chunk's start, then the chunk again
    before = (A[:, :, :-1] @ s0[:, :, None, :, None])[..., 0] + c[:, :, :-1]
    v = list(torch.cat([s0[:, :, None], before], dim=2)
             .reshape(rows, groups * GROUP, STATE).unbind(-1))
    wet = torch.empty_like(xr)
    for t in range(chunk):
        wet[..., t] = _step(v, ar[..., t], fb[..., 0], xr[..., t])
    wet = wet.reshape(rows, -1)[:, :T].reshape(B, C, T)
    m = mix[:, None, None]
    return (1.0 - m) * x + m * wet


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
    lib.remfx_phaser.argtypes = [ptr] * 7 + [i32, i32, i64, ptr]
    lib.remfx_phaser_serial.argtypes = [ptr] * 5 + [i32, i32, i64, ptr]
    lib.remfx_phaser.restype = lib.remfx_phaser_serial.restype = i32
    return lib


def _launch(fn, *args, device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"phaser kernel launch failed: CUDA error {err}")


def _on_card(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no phaser kernel for device {x.device}")


def phaser(x: torch.Tensor, a: torch.Tensor, feedback: torch.Tensor,
           mix: torch.Tensor) -> torch.Tensor:
    """The phaser over the last axis -> (B, C, T) fp32; on the card the
    split kernel."""
    _check(x, a, feedback, mix)
    if x.device.type == "cpu":
        return phaser_plain(x, a, feedback, mix)
    _on_card(x)
    B, C, T = x.shape
    chunks = -(-T // CHUNK)
    groups = -(-chunks // GROUP)
    out = torch.empty_like(x)
    n_maps = B * C * groups * GROUP * _MAP  # a multiple of 4: starts stay aligned
    scratch = torch.empty(n_maps + B * C * groups * _START, dtype=torch.float32,
                          device=x.device)
    _launch(_lib().remfx_phaser, x.data_ptr(), a.data_ptr(), feedback.data_ptr(),
            mix.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch[n_maps:].data_ptr(), B, C, T, device=x.device)
    phaser.launches += 1
    return out


def phaser_serial(x: torch.Tensor, a: torch.Tensor, feedback: torch.Tensor,
                  mix: torch.Tensor) -> torch.Tensor:
    """The serial kernel (one thread walks each row), bit for bit
    ``phaser_plain``: the split kernel's oracle; no path of the port calls
    it. A CPU tensor takes ``phaser_plain``. ``phaser_serial.launches``
    counts."""
    _check(x, a, feedback, mix)
    if x.device.type == "cpu":
        return phaser_plain(x, a, feedback, mix)
    _on_card(x)
    B, C, T = x.shape
    out = torch.empty_like(x)
    _launch(_lib().remfx_phaser_serial, x.data_ptr(), a.data_ptr(),
            feedback.data_ptr(), mix.data_ptr(), out.data_ptr(), B, C, T,
            device=x.device)
    phaser_serial.launches += 1
    return out


phaser.launches = 0
phaser_serial.launches = 0
