"""Envelope follower of the port against the JAX package.

``envelope_plain`` (the plain version the CUDA kernel is held against)
is compared with ``remfx_tpu.fx.compressor.envelope_scan`` and with the
TPU kernel ``remfx_tpu.ops.pallas_env.envelope_pallas`` run in interpret
mode, which is how the JAX package runs its kernel on a CPU.

Tolerance: 2e-4 x the row's peak. The recurrence is fp32 rounding,
amplified by up to 1/(1 - cte), about 1900 at the 250 ms release pole;
in practice the error is far smaller, and the bound is asserted.

``_split_model`` is a plain model of the CUDA kernel's three passes
(``csrc/envelope.cu``: bounds, bracketed chunks, repair), in
``envelope_plain``'s arithmetic; it must equal ``envelope_plain`` bit for
bit, which proves the bracket and the repair walk on the CPU.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx.compressor import ballistics_cte as jax_cte
from remfx_tpu.fx.compressor import envelope_scan
from remfx_tpu.ops.pallas_env import envelope_pallas
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.fx.compressor import ballistics_cte
from remfx_tpu_torch.ops.envelope import (CHUNK, WARM_TAU, envelope,
                                          envelope_flags, envelope_plain,
                                          envelope_serial)

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


# ---- the split kernel's passes, modelled on the CPU ----

DEMO = Path(__file__).resolve().parents[1] / "demos" / "example_48k_mono.wav"
SPLIT_ROWS, SPLIT_T, SPLIT_L, SPLIT_W_CAP = 4, 8192, 256, 4096
HIT = 600  # samples of the hit before the silence


def _step(xa, env, at, rl):
    """One step in envelope_plain's arithmetic."""
    cte = torch.where(xa > env, at, rl)
    return xa + cte * (env - xa)


def _bits(v):
    return v.view(torch.int32)


def _warm_steps(at, rl, T, tau=WARM_TAU):
    """csrc/envelope.cu:warm_steps per row: ceil(tau / (1 - max(at, rl)))
    rounded up to 32 samples; T where the coefficients do not contract."""
    c = torch.maximum(at, rl)
    w = torch.ceil(torch.tensor(tau, dtype=torch.float32) / (1.0 - c))
    ok = (at >= 0) & (rl >= 0) & (c < 1) & (w < T)
    w = torch.where(ok, w, torch.zeros_like(w)).to(torch.int64)
    return torch.where(ok, (w + 31) // 32 * 32, torch.full_like(w, T))


def _split_model(x, at, rl, L, W):
    """Passes 0-2 of the split kernel for x (B, T), chunk L and per-row
    warm-up W (B,) -> (env, unresolved (B, n), bracketed (B, n)), where
    bracketed marks the chunks whose start the bracket proved exact."""
    B, T = x.shape
    n = -(-T // L)
    # pass 0: bounds of the envelope
    lo0 = x.amin(dim=1).clamp_max(0.0)
    hi0 = x.amax(dim=1).clamp_min(0.0)
    # pass 1: every (row, chunk) at once
    s = torch.arange(n) * L
    first = s[None] - W[:, None]  # (B, n): first warm-up sample
    exact = first <= 0
    first = first.clamp_min(0)
    lo = torch.where(exact, 0.0, lo0[:, None])
    hi = torch.where(exact, 0.0, hi0[:, None])
    a, r = at[:, None], rl[:, None]
    for j in range(-int((s[None] - first).max()), 0):
        pos = (s + j).expand(B, n)
        active = pos >= first
        xa = x.gather(1, pos.clamp_min(0))
        lo = torch.where(active, _step(xa, lo, a, r), lo)
        hi = torch.where(active, _step(xa, hi, a, r), hi)
    unresolved = _bits(lo) != _bits(hi)
    xp = torch.nn.functional.pad(x, (0, n * L - T)).view(B, n, L)
    chunks = torch.empty_like(xp)
    env = hi
    for j in range(L):
        env = _step(xp[:, :, j], env, a, r)
        chunks[:, :, j] = env
    out = chunks.view(B, n * L)[:, :T].clone()
    # pass 2: rerun the unresolved chunks from the exact value before them
    for c in range(1, n):
        walking = unresolved[:, c].clone()
        env = out[:, c * L - 1].clone()
        for t in range(c * L, min(c * L + L, T)):
            if not walking.any():
                break
            v = _step(x[:, t], env, at, rl)
            stored = out[:, t].clone()
            out[:, t] = torch.where(walking, v, stored)
            walking &= _bits(v) != _bits(stored)
            env = v
    return out, unresolved, ~exact & ~unresolved


def _demo_rows(rows, T, seed=0):
    x, _ = read_wav(DEMO)
    starts = np.random.default_rng(seed).integers(0, x.shape[1] - T, rows)
    return np.stack([np.abs(x[0, o:o + T]) for o in starts]).astype(np.float32)


def _split_case(name):
    """x_abs (rows, T) and per-row attack/release in ms, and whether W is
    capped at SPLIT_W_CAP (uncapped, the 250 ms rows warm up past T)."""
    T = {"t_not_multiple_of_l": 5000, "t_below_l": 200}.get(name, SPLIT_T)
    x = _demo_rows(SPLIT_ROWS, T)
    attack = np.array([1.0, 50.0, 1.0, 50.0], np.float32)
    release = np.array([10.0, 250.0, 250.0, 10.0], np.float32)
    if name == "hit_then_silence":
        x[0, HIT:] = 0.0
        x[2, 3000:] = 0.0
        release[0] = 250.0
    elif name == "zero_row":
        x[1] = 0.0
    elif name == "fast_attack":
        attack[:2] = 5e-4  # cte_at = 0
    return x, attack, release, name != "t_below_w"


SPLIT_CASES = ["demo", "hit_then_silence", "zero_row", "fast_attack",
               "t_not_multiple_of_l", "t_below_l", "t_below_w"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_model_equals_plain_bit_for_bit(name):
    xa, attack, release, capped = _split_case(name)
    at, rl = _coeffs(attack, release)
    x = torch.from_numpy(xa)
    W = _warm_steps(at, rl, x.shape[1])
    if capped:
        W = W.clamp_max(SPLIT_W_CAP)
    got, unresolved, bracketed = _split_model(x, at, rl, SPLIT_L, W)
    assert torch.equal(got, envelope_plain(x, at, rl))
    if name == "demo":  # the bracket closes, and pass 2 has work too
        assert bracketed.any() and unresolved.any()
    if name == "hit_then_silence":  # a warm-up wholly in silence never closes
        quiet = torch.arange(unresolved.shape[1]) * SPLIT_L - W[0] > HIT
        assert quiet.any() and unresolved[0, quiet].all()
    if name == "t_below_w":  # such rows start every chunk from position 0
        long = W >= x.shape[1]
        assert long.any() and not (bracketed | unresolved)[long].any()


def test_warm_up_rule():
    at, rl = _coeffs(np.array([1.0, 50.0, 5e-4, 1.0], np.float32),
                     np.array([10.0, 250.0, 250.0, 1e9], np.float32))
    W = _warm_steps(at, rl, 1 << 20)
    tau = 48000 * np.array([10.0, 250.0, 250.0]) / 1000 / (2 * np.pi)
    assert (W[:3].numpy() % 32 == 0).all()
    np.testing.assert_allclose(W[:3].numpy(), WARM_TAU * tau, rtol=0.03)
    assert W[3].item() == 1 << 20  # cte_rl rounds to 1: no contraction


def test_chunk_and_warm_up_constants_match_the_kernel_source():
    # the wrapper sizes the chunk flags by CHUNK; the kernel compiles kChunk in
    src = (Path(__file__).resolve().parents[1] / "remfx_tpu_torch" / "csrc"
           / "envelope.cu").read_text()
    chunk = re.search(r"constexpr long long kChunk = (\d+);", src)
    tau = re.search(r"constexpr float kWarmTau = ([\d.]+)f;", src)
    assert int(chunk.group(1)) == CHUNK and CHUNK % 32 == 0
    assert float(tau.group(1)) == WARM_TAU


def test_serial_and_flags_wrappers_on_cpu():
    xa, attack, release = _inputs()
    at, rl = _coeffs(attack, release)
    x = torch.from_numpy(xa)
    before = envelope_serial.launches
    assert torch.equal(envelope_serial(x, at, rl), envelope_plain(x, at, rl))
    assert envelope_serial.launches == before
    with pytest.raises(ValueError):
        envelope_flags(x, at, rl)  # the chunk flags exist only on the card
