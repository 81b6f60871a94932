"""Envelope follower of the port against the JAX package.

``envelope_plain`` (the plain version the CUDA kernel is held against)
is compared with ``remfx_tpu.fx.compressor.envelope_scan`` and with the
TPU kernel ``remfx_tpu.ops.pallas_env.envelope_pallas`` run in interpret
mode, which is how the JAX package runs its kernel on a CPU.

Tolerance: 2e-4 x the row's peak. The recurrence is fp32 rounding,
amplified by up to 1/(1 - cte), about 1900 at the 250 ms release pole;
in practice the error is far smaller, and the bound is asserted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx.compressor import ballistics_cte as jax_cte
from remfx_tpu.fx.compressor import envelope_scan
from remfx_tpu.ops.pallas_env import envelope_pallas
from remfx_tpu_torch.fx.compressor import ballistics_cte
from remfx_tpu_torch.ops.envelope import envelope, envelope_plain

torch.set_num_threads(2)
SR = 48000
B, T = 3, 5000  # neither a multiple of 128 rows nor of 2048 samples
TOL = 2e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T)).astype(np.float32)
    x *= np.linspace(0.05, 1.0, T, dtype=np.float32)[None]  # rising level
    x[:, T // 2 :] *= 0.1  # a drop, so the release branch runs
    xa = np.abs(x).astype(np.float32)
    # per-row times; row 2 has the fast-attack edge (< 1e-3 ms -> cte 0)
    attack = np.array([1.0, 50.0, 5e-4], np.float32)
    release = np.array([10.0, 250.0, 100.0], np.float32)
    return xa, attack, release


def _coeffs(attack, release):
    at = ballistics_cte(torch.from_numpy(attack), SR)
    rl = ballistics_cte(torch.from_numpy(release), SR)
    return at, rl


def test_cte_matches_jax_and_fast_attack_is_zero():
    _, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    np.testing.assert_array_equal(at.numpy(), np.asarray(jax_cte(jnp.asarray(attack), SR)))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jax_cte(jnp.asarray(release), SR)))
    assert at[2].item() == 0.0


@pytest.mark.parametrize("ref", ["scan", "pallas_interpret"])
def test_plain_matches_jax(ref):
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    got = envelope_plain(torch.from_numpy(xa), at, rl).numpy()
    ja, jr = jnp.asarray(at.numpy()), jnp.asarray(rl.numpy())
    if ref == "scan":
        want = np.asarray(envelope_scan(jnp.asarray(xa), ja, jr))
    else:
        want = np.asarray(envelope_pallas(jnp.asarray(xa), ja, jr, interpret=True))
    assert got.shape == want.shape == (B, T)
    peak = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want) / peak
    assert err.max() <= TOL, err.max()


def test_fast_attack_row_follows_input_on_rises():
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    env = envelope_plain(torch.from_numpy(xa), at, rl).numpy()[2]
    prev = np.concatenate([[0.0], env[:-1]])
    rises = xa[2] > prev
    np.testing.assert_array_equal(env[rises], xa[2][rises])


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    before = envelope.launches
    got = envelope(torch.from_numpy(xa), at, rl)
    assert envelope.launches == before
    torch.testing.assert_close(got, envelope_plain(torch.from_numpy(xa), at, rl),
                               rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    x = torch.from_numpy(xa)
    with pytest.raises(TypeError):
        envelope(x.double(), at, rl)
    with pytest.raises(ValueError):
        envelope(x[:, ::2], at, rl)  # not contiguous
    with pytest.raises(ValueError):
        envelope(x[None], at, rl)
    with pytest.raises(ValueError):
        envelope(x, at[:2].contiguous(), rl)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    dev = torch.device("cuda")
    launches = envelope.launches
    got = envelope(torch.from_numpy(xa).to(dev), at.to(dev), rl.to(dev))
    torch.cuda.synchronize()
    assert envelope.launches == launches + 1
    want = envelope_plain(torch.from_numpy(xa), at, rl).numpy()
    peak = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got.cpu().numpy() - want) / peak).max() <= TOL
