"""Compressor render of the port against the JAX package, with explicit
parameters (the two packages' random generators differ).

Tolerance: 1e-5 x the peak. Both sides run the same fp32 recurrence and
gain; what differs is rounding order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx import compressor as jcomp
from remfx_tpu_torch.fx import compressor as tcomp

torch.set_num_threads(2)
SR = 48000
B, C, T = 2, 1, 8192
TOL = 1e-5


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    x *= np.linspace(0.1, 0.9, T, dtype=np.float32)
    return (0.8 * x / np.abs(x).max()).astype(np.float32)


PARAMS = {
    "threshold_db": np.array([-30.0, -20.0], np.float32),
    "ratio": np.array([4.0, 1.5], np.float32),
    "attack_ms": np.array([1.0, 5e-4], np.float32),  # row 1: fast-attack edge
    "release_ms": np.array([250.0, 10.0], np.float32),
}


def _close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


def test_render_batch_matches_jax():
    x = _audio()
    want = np.asarray(jcomp.render_batch(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in PARAMS.items()}, SR))
    got = tcomp.render_batch(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in PARAMS.items()}, SR)
    _close(got.numpy(), want)


@pytest.mark.parametrize("i", [0, 1])
def test_render_matches_jax(i):
    x = _audio()[i]  # (C, T), scalar params
    p = {k: float(v[i]) for k, v in PARAMS.items()}
    want = np.asarray(jcomp.render(
        jnp.asarray(x), {k: jnp.float32(v) for k, v in p.items()}, SR))
    got = tcomp.render(torch.from_numpy(x), p, SR)
    _close(got.numpy(), want)


def test_render_batch_equals_per_example_render():
    x = torch.from_numpy(_audio())
    params = {k: torch.from_numpy(v) for k, v in PARAMS.items()}
    batch = tcomp.render_batch(x, params, SR)
    for i in range(B):
        one = tcomp.render(x[i], {k: v[i] for k, v in params.items()}, SR)
        torch.testing.assert_close(batch[i], one, rtol=0, atol=0)


def test_compression_reduces_level_above_threshold():
    x = torch.from_numpy(_audio())
    params = {k: torch.from_numpy(v) for k, v in PARAMS.items()}
    y = tcomp.render_batch(x, params, SR)
    assert torch.all(y.abs() <= x.abs() + 1e-7)
    assert y.abs().max() < x.abs().max()


def test_sample_params_in_range_and_seeded():
    g = torch.Generator().manual_seed(0)
    ranges = {"min_threshold_db": -42.0, "max_threshold_db": -20.0,
              "min_ratio": 1.5, "max_ratio": 6.0}
    p = tcomp.sample_params(g, 64, ranges, device="cpu")
    assert set(p) == {"threshold_db", "ratio", "attack_ms", "release_ms"}
    assert p["threshold_db"].shape == (64,)
    assert -42.0 <= p["threshold_db"].min() and p["threshold_db"].max() < -20.0
    assert 1.5 <= p["ratio"].min() and p["ratio"].max() < 6.0
    assert 1.0 <= p["attack_ms"].min() and p["attack_ms"].max() < 50.0
    assert 10.0 <= p["release_ms"].min() and p["release_ms"].max() < 250.0
    q = tcomp.sample_params(torch.Generator().manual_seed(0), 64, ranges, device="cpu")
    for k in p:
        assert torch.equal(p[k], q[k])
