"""Biquad design and IIR filtering in log2(T) parallel passes.

Counterpart of ``remfx_tpu/ops/biquad.py``. The design is the RBJ
cookbook's, as the reference's ``biqaud`` (remfx/effects.py:37-91). The
JAX package runs the order-2 recurrence

    y[n] = f[n] - a1*y[n-1] - a2*y[n-2],   f = b0*x[n] + b1*x[n-1] + b2*x[n-2]

as ``lax.associative_scan`` over 2x2 affine maps on the state
``s[n] = (y[n], y[n-1]) = M s[n-1] + (f[n], 0)``. With zero initial state
only the affine parts matter, and the map that spans ``2^k`` steps is
``M^(2^k)``, the same at every position: so the port runs the recursive
doubling ``v[t] += M^(2^k) v[t - 2^k]`` for k = 0, 1, ..., ceil(log2 T)-1
(18 passes at T = 262144), each a few elementwise tensor ops, with the
per-row 2x2 powers formed by squaring. No Python loop runs over samples.

The scan runs in float64 and is rounded once. In fp32 a scan of this
companion form loses the filter near poles at |z| = 1, where the entries
of ``M^k`` grow and cancel: against float64 ``scipy.signal.lfilter``,
an fp32 doubling scan is off by 1.3 % of the peak for a 20 Hz low shelf
and 9 % for the K-weighting high-pass (38 Hz) on a signal with a DC
offset, and the JAX package's fp32 ``associative_scan`` by 116 % and
9100 %. In float64 the port matches ``lfilter`` of the same fp32
coefficients to the fp32 rounding of the output.
"""

from __future__ import annotations

import math

import torch


def biquad_coeffs(gain_db, cutoff_freq, q_factor, sample_rate, filter_type: str):
    """RBJ biquad -> ``(b, a)``, each ``(..., 3)`` with ``a[..., 0] == 1``.
    Scalars or tensors (vectorised over their shape), computed in fp32."""
    gain_db, cutoff_freq, q_factor = (
        torch.as_tensor(v, dtype=torch.float32)
        for v in (gain_db, cutoff_freq, q_factor))
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * (cutoff_freq / sample_rate)
    alpha = torch.sin(w0) / (2.0 * q_factor)
    cos_w0 = torch.cos(w0)
    sqrt_A = torch.sqrt(A)

    if filter_type == "high_shelf":
        b0 = A * ((A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cos_w0)
        b2 = A * ((A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cos_w0)
        a2 = (A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    elif filter_type == "low_shelf":
        b0 = A * ((A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cos_w0)
        b2 = A * ((A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cos_w0)
        a2 = (A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    elif filter_type == "peaking":
        b0 = 1 + alpha * A
        b1 = -2 * cos_w0
        b2 = 1 - alpha * A
        a0 = 1 + alpha / A
        a1 = -2 * cos_w0
        a2 = 1 - alpha / A
    else:
        raise ValueError(f"unknown filter_type {filter_type}")

    b = torch.stack([b0 / a0, b1 / a0, b2 / a0], dim=-1)
    a = torch.stack([torch.ones_like(a0), a1 / a0, a2 / a0], dim=-1)
    return b, a


def _shift(v: torch.Tensor, d: int) -> torch.Tensor:
    """``v`` delayed by ``d`` samples along the last axis, zeros in front."""
    return torch.nn.functional.pad(v[..., :-d], (d, 0))


def _ar2(f: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Solve ``y[n] = f[n] - a1*y[n-1] - a2*y[n-2]`` (zero initial state)
    by recursive doubling. ``a1``/``a2`` broadcast to ``f[..., 0]``."""
    shape = f.shape[:-1]
    # M = [[-a1, -a2], [1, 0]] per row, as (..., 1) columns
    m11 = torch.broadcast_to(-a1, shape)[..., None]
    m12 = torch.broadcast_to(-a2, shape)[..., None]
    m21 = torch.ones_like(m11)
    m22 = torch.zeros_like(m11)
    v1, v2 = f, torch.zeros_like(f)
    d = 1
    while d < f.shape[-1]:
        s1, s2 = _shift(v1, d), _shift(v2, d)
        v1, v2 = v1 + m11 * s1 + m12 * s2, v2 + m21 * s1 + m22 * s2
        m11, m12, m21, m22 = (m11 * m11 + m12 * m21, m11 * m12 + m12 * m22,
                              m21 * m11 + m22 * m21, m21 * m12 + m22 * m22)
        d *= 2
    return v1


def biquad_filter(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One biquad (zero initial conditions) along the last axis of ``x``.

    ``b``/``a``: ``(..., 3)`` with ``a[..., 0] == 1``, broadcastable to
    ``x``'s leading dims. ``scipy.signal.lfilter(b, a, x)`` (computed in
    float64) rounded to ``x``'s dtype."""
    b = torch.as_tensor(b, device=x.device).to(torch.float64)
    a = torch.as_tensor(a, device=x.device).to(torch.float64)
    x64 = x.to(torch.float64)
    f = b[..., 0:1] * x64 + b[..., 1:2] * _shift(x64, 1) + b[..., 2:3] * _shift(x64, 2)
    return _ar2(f, a[..., 1], a[..., 2]).to(x.dtype)


def sosfilt(sos_b: torch.Tensor, sos_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cascade of biquad sections; ``sos_b``/``sos_a`` ``(n_sections, ..., 3)``."""
    for b, a in zip(sos_b, sos_a):
        x = biquad_filter(b, a, x)
    return x
