"""Multichannel Wiener filtering with expectation-maximization (EM).

Counterpart of ``remfx_tpu/ops/wiener.py``: the separation post-filter of
the reference's UMX ``Separator`` (sigsep/open-unmix-pytorch, the norbert
algorithm), with the same semantics:

- initial estimates: the ``softmask`` ratio mask, or the magnitude
  estimate with the mixture phase;
- the optional residual source ``mix - sum(estimates)``, appended last
  (EM on a single target needs it);
- each iteration: PSDs ``v_j = mean_c |y_j|^2``; spatial covariances
  ``R_j = sum_t y_j y_j^H / (eps + sum_t v_j)``; the mix covariance
  ``Cxx = sqrt(eps) I + sum_j v_j R_j``; gains ``W_j = v_j R_j Cxx^-1``;
  ``y_j = W_j x``;
- the mix and the estimates scaled by ``max(1, |x|_max / 10)`` before
  EM, and back after;
- the EM statistics taken per window of ``wiener_win_len`` frames,
  independently (frames zero-padded to whole windows: zero frames add
  nothing to the sums).

The JAX package carries complex values as (re, im) planes because the TPU
has no complex dtype; here they are ``complex64``. The inverse of the
covariance stays the closed form for 1 and 2 channels with its ``eps``
in the denominator (upstream ``_invert``), which a general inverse would
not reproduce at the bins where ``Cxx`` is singular.

Shapes: estimates ``(frames, bins, C, S)``, the mixture ``(frames, bins,
C)``, for one example (``models/umx.py`` calls it per example, as the JAX
package's ``vmap`` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def _invert(m: torch.Tensor, eps: float) -> torch.Tensor:
    """Inverse of a ``(..., C, C)`` complex matrix, C in {1, 2} (closed
    form, ``eps`` added to ``|det|^2``)."""
    C = m.shape[-1]
    if C == 1:
        return m.conj() / (_abs2(m) + eps)
    if C == 2:
        det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv_det = det.conj() / (_abs2(det) + eps)
        adj = torch.stack([
            torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
            torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1),
        ], -2)
        return adj * inv_det[..., None, None]
    raise NotImplementedError(f"only 1/2 channels supported, got {C}")


def expectation_maximization(y: torch.Tensor, x: torch.Tensor, iterations: int,
                             eps: float = 1e-10) -> torch.Tensor:
    """EM refinement of source STFT estimates.

    ``y``: (..., frames, bins, C, S) complex estimates; ``x``: (...,
    frames, bins, C) complex mixture; leading dimensions are independent
    (the windows). Returns the refined ``y``."""
    C = x.shape[-1]
    eye = torch.eye(C, dtype=y.dtype, device=y.device)
    for _ in range(iterations):
        v = _abs2(y).mean(-2)  # (..., f, b, S)
        # R_j = sum_t y_c conj(y_d) / (eps + sum_t v_j): (..., b, C, C, S)
        R = torch.einsum("...fbcs,...fbds->...bcds", y, y.conj())
        weight = eps + v.sum(-3)  # (..., b, S)
        R = R / weight[..., None, None, :]
        vc = v.to(y.dtype)
        Cxx = eps ** 0.5 * eye + torch.einsum("...fbs,...bcds->...fbcd", vc, R)
        inv = _invert(Cxx, eps)
        # W_j = v_j R_j Cxx^-1: (..., f, b, C, C, S); y_j = W_j x
        W = vc[..., None, None, :] * torch.einsum("...bcds,...fbde->...fbces", R, inv)
        y = torch.einsum("...fbcds,...fbd->...fbcs", W, x)
    return y


def wiener(targets_mag: torch.Tensor, x: torch.Tensor, niter: int = 1,
           softmask: bool = False, residual: bool = False,
           wiener_win_len: int | None = 300, scale_factor: float = 10.0,
           eps: float = 1e-10) -> torch.Tensor:
    """Wiener filter source estimates from magnitude models.

    ``targets_mag``: (frames, bins, C, S) magnitudes; ``x``: (frames,
    bins, C) complex mixture STFT. Returns (frames, bins, C, S + residual)
    complex."""
    if softmask:
        mask = targets_mag / (eps + targets_mag.sum(-1, keepdim=True))
        y = x[..., None] * mask
    else:
        # upstream seeds with the mixture phase via atan2(im, re);
        # atan2(0, 0) = 0, so an exactly-zero mixture bin seeds EM with
        # (targets_mag, 0)
        ang = torch.atan2(x.imag, x.real)[..., None]
        y = torch.complex(targets_mag * torch.cos(ang), targets_mag * torch.sin(ang))
    if residual:
        y = torch.cat([y, (x - y.sum(-1))[..., None]], -1)
    if niter == 0:
        return y
    if y.shape[-1] == 1:
        raise ValueError(
            "Cannot run EM on a single target; set residual=True "
            "(upstream Separator raises the same way).")
    max_abs = torch.clamp(x.abs().max() / scale_factor, min=1.0)
    x, y = x / max_abs, y / max_abs

    frames = x.shape[0]
    win = int(wiener_win_len) if wiener_win_len else frames
    n_win = -(-frames // win)
    pad = n_win * win - frames

    def windows(a):  # (frames, ...) -> (n_win, win, ...)
        a = torch.view_as_real(a)
        a = F.pad(a, [0, 0] * (a.ndim - 1) + [0, pad])
        return torch.view_as_complex(a.reshape((n_win, win) + a.shape[1:]).contiguous())

    y_w = expectation_maximization(windows(y), windows(x), niter, eps)
    y = y_w.reshape((n_win * win,) + y.shape[1:])[:frames]
    return y * max_abs
