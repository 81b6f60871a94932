"""The port's Wiener EM (``remfx_tpu_torch/ops/wiener.py``, complex64)
against the JAX package's (``remfx_tpu/ops/wiener.py``, (re, im) planes)
on the CPU, on the cases of ``tests/test_wiener.py`` and on random
inputs from a numpy seed.

Tolerances: the closed-form inverse at 1e-6 of the largest entry (one
complex product and division in another order; a determinant that is
itself rounding noise would differ by its whole size, so the singular
case has an exactly zero one); the estimates at 1e-5
of their largest magnitude (measured at most 1.9e-6, one EM iteration
with two channels and a softmask start). A singular 2 x 2 matrix gives the same
finite inverse on both sides: ``eps`` in the denominator is kept.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.ops import wiener as jw
from remfx_tpu_torch.ops import wiener as tw

TOL = 1e-5


def _c(shape, rng):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jax(fn, tm, x, **kw):
    # jit: eager JAX compiles each einsum on its own, several times slower
    yr, yi = jax.jit(functools.partial(fn, **kw))(
        jnp.asarray(tm), jnp.asarray(x.real), jnp.asarray(x.imag))
    return np.asarray(yr) + 1j * np.asarray(yi)


def _port(fn, tm, x, **kw):
    return fn(torch.from_numpy(tm), torch.from_numpy(x), **kw).numpy()


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("C,eps,singular", [(1, 0.0, False), (2, 0.0, False),
                                             (1, 1e-10, False), (2, 1e-10, False),
                                             (2, 1e-10, True)],
                         ids=["c1", "c2", "c1_eps", "c2_eps", "c2_singular"])
def test_invert_matches_jax(C, eps, singular):
    rng = np.random.default_rng(C)
    m = _c((6, C, C), rng)
    if singular:
        m[0, 1] = m[0, 0]  # equal rows: det is exactly 0 in any order
    ir, ii = jax.jit(jw._invert, static_argnums=2)(jnp.asarray(m.real),
                                                   jnp.asarray(m.imag), eps)
    want = np.asarray(ir) + 1j * np.asarray(ii)
    got = tw._invert(torch.from_numpy(m), eps).numpy()
    assert np.isfinite(got).all()
    _close(got, want, 1e-6)
    if not singular and eps == 0.0:
        prod = np.einsum("bij,bjk->bik", m, got)
        np.testing.assert_allclose(prod, np.broadcast_to(np.eye(C), prod.shape), atol=1e-4)


def test_invert_rejects_three_channels():
    with pytest.raises(NotImplementedError):
        tw._invert(torch.zeros(2, 3, 3, dtype=torch.complex64), 0.0)


def test_niter0_is_mixture_phase():
    rng = np.random.default_rng(1)
    x = _c((7, 11, 1), rng)
    tm = np.abs(rng.standard_normal((7, 11, 1, 1))).astype(np.float32)
    got = _port(tw.wiener, tm, x, niter=0)
    _close(got, _jax(jw.wiener, tm, x, niter=0))
    np.testing.assert_allclose(got[..., 0], tm[..., 0] * x / np.abs(x), atol=1e-5)


def test_softmask_sums_to_mix():
    rng = np.random.default_rng(2)
    x = _c((5, 9, 1), rng)
    tm = (np.abs(rng.standard_normal((5, 9, 1, 3))) + 0.1).astype(np.float32)
    got = _port(tw.wiener, tm, x, niter=0, softmask=True)
    _close(got, _jax(jw.wiener, tm, x, niter=0, softmask=True))
    np.testing.assert_allclose(got.sum(-1), x, atol=1e-4)


def test_single_target_requires_residual():
    tm = np.ones((4, 6, 1, 1), np.float32)
    x = np.ones((4, 6, 1), np.complex64)
    with pytest.raises(ValueError):
        _jax(jw.wiener, tm, x, niter=1, residual=False)
    with pytest.raises(ValueError):
        _port(tw.wiener, tm, x, niter=1, residual=False)


def test_windowed_em_equals_per_window_em():
    """A window that divides the frames: the same as EM on each window
    alone, and as the JAX package's windowed EM."""
    rng = np.random.default_rng(4)
    x = _c((20, 8, 1), rng)
    tm = (np.abs(rng.standard_normal((20, 8, 1, 2))) + 0.05).astype(np.float32)
    got = _port(tw.wiener, tm, x, niter=1, wiener_win_len=10)
    halves = np.concatenate([_port(tw.wiener, tm[s], x[s], niter=1, wiener_win_len=None)
                             for s in (slice(0, 10), slice(10, 20))])
    np.testing.assert_allclose(got, halves, atol=2e-4)
    _close(got, _jax(jw.wiener, tm, x, niter=1, wiener_win_len=10))


@pytest.mark.parametrize("niter", [1, 2])
@pytest.mark.parametrize("C,S,residual,softmask,win", [
    (1, 1, True, False, 300), (2, 2, False, False, 300), (2, 1, True, True, 7),
    (1, 3, True, False, None)], ids=["c1s1res", "c2s2", "c2s1res_soft_win7", "c1s3res"])
def test_em_matches_jax(niter, C, S, residual, softmask, win):
    """Random estimates and mix, loud enough that the rescale by
    |x|_max / 10 runs."""
    rng = np.random.default_rng(10 * niter + C + S)
    x = 20 * _c((23, 17, C), rng)
    tm = (20 * np.abs(rng.standard_normal((23, 17, C, S)))).astype(np.float32)
    kw = dict(niter=niter, residual=residual, softmask=softmask, wiener_win_len=win)
    got = _port(tw.wiener, tm, x, **kw)
    assert got.shape[-1] == S + residual and np.isfinite(got).all()
    _close(got, _jax(jw.wiener, tm, x, **kw))


def test_em_keeps_disjoint_sources():
    """Two sources on disjoint bins with exact magnitudes: EM keeps each
    close to the truth, as in the JAX package's test."""
    rng = np.random.default_rng(3)
    s1 = np.zeros((64, 16, 1), np.complex64)
    s2 = np.zeros((64, 16, 1), np.complex64)
    s1[:, :8] = _c((64, 8, 1), rng)
    s2[:, 8:] = _c((64, 8, 1), rng)
    tm = np.stack([np.abs(s1), np.abs(s2)], -1).astype(np.float32)
    got = _port(tw.wiener, tm, s1 + s2, niter=2, wiener_win_len=None)
    err = np.linalg.norm(got[..., 0] - s1) / np.linalg.norm(s1)
    assert err < 0.15
    _close(got, _jax(jw.wiener, tm, s1 + s2, niter=2, wiener_win_len=None))
