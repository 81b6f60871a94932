"""The port's sox-style reverb (``fx/sox_reverb.py``) against the JAX
package's ``remfx_tpu/fx/sox_reverb.py``.

At T = 16384 with the default ranges (``max_room_scale`` 100,
``max_pre_delay`` 100 ms) both packages pad to a 2^21-point FFT, the size a
262144-sample chunk takes too. Tolerances, of the JAX output's peak per
row:

  * against JAX's ``_render_fft``: 1e-3. Measured 6.1e-4 in the largest
    corner (reverberance 100, room 100, pre-delay 100 ms, all wet), 2.0e-5
    in the middle and 8.8e-7 in a small room. Both packages form the
    angles ``w * L`` and ``w * D`` in fp32, up to 1.5e4 rad, so an ulp of
    ``w`` moves them by 1e-3 rad; the JAX package then takes XLA's ``cos``
    / ``sin`` of them and its fp32 DFT-as-matmul. Against a float64 render
    of the same formula (tolerance 5e-4) the port is 3.3e-4 off in that
    corner and JAX 9.5e-4: the port is the closer of the two;
  * ``wet_dry = 0`` is the identity bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx import sox_reverb as jsox
from remfx_tpu_torch.fx import make_effect
from remfx_tpu_torch.fx import sox_reverb as tsox

torch.set_num_threads(2)
SR = 48000
T = 16384
# the largest corner; a middle setting; a small, damped, dry-ish room
PARAMS = {"reverberance": [100.0, 60.0, 10.0],
          "high_freq_damping": [0.0, 50.0, 99.0],
          "room_scale": [100.0, 40.0, 5.0],
          "stereo_depth": [50.0, 20.0, 100.0],
          "wet_dry": [1.0, 0.5, 0.2],
          "pre_delay": [100.0, 20.0, 0.0]}


def _audio(rows=3, C=1, T=T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    x *= np.linspace(1.0, 0.2, T, dtype=np.float32)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _row(p, i):
    return {k: np.float32(v[i]) for k, v in p.items()}


def _float64(x, p):
    """``_render_fft``'s formula in float64 at the same rounded lengths."""
    n_fft = tsox.fft_size(x.shape[-1], tsox.DEFAULT_RANGES, SR)
    fb = 1 - np.exp((p["reverberance"] - tsox._B) / (tsox._A * tsox._B))
    damp = p["high_freq_damping"] / 100 * 0.3 + 0.7
    r = np.float32(SR / 44100.0) * np.float32(p["room_scale"] / 100 * 0.9 + 0.1)
    w = np.arange(n_fft // 2 + 1) * (2 * np.pi / n_fft)
    d1 = 1 - damp * np.exp(-1j * w)
    H = np.zeros_like(w, dtype=complex)
    for L0 in tsox.COMB_TUNINGS:
        zl = np.exp(-1j * w * np.round(np.float32(L0 * r)))
        H += zl * d1 / (d1 - fb * (1 - damp) * zl)
    for L0 in tsox.ALLPASS_TUNINGS:
        zl = np.exp(-1j * w * np.round(np.float32(L0 * r)))
        H *= (1.5 * zl - 1) / (1 - 0.5 * zl)
    H *= 0.015 * np.exp(-1j * w * p["pre_delay"] / 1000 * SR)
    wet = np.fft.irfft(np.fft.rfft(x.astype(np.float64), n_fft) * H, n_fft)[..., :x.shape[-1]]
    return x * (1 - p["wet_dry"]) + wet * p["wet_dry"]


@pytest.fixture(scope="module")
def renders():
    x = _audio()
    jeff = jsox.make(SR)
    want = np.stack([np.asarray(jeff.render(jnp.asarray(x[i]), _row(PARAMS, i)))
                     for i in range(3)])
    got = make_effect("sox_reverb", SR, device="cpu").render_batch(
        torch.from_numpy(x), {k: torch.tensor(v) for k, v in PARAMS.items()}).numpy()
    return x, got, want


@pytest.mark.parametrize("row", [0, 1, 2])
def test_sox_reverb_matches_jax(renders, row):
    x, got, want = renders
    assert got.shape == x.shape and np.isfinite(got).all()
    assert np.abs(got[row] - want[row]).max() / np.abs(want[row]).max() <= 1e-3


def test_sox_reverb_port_is_within_the_fp32_angle_error_of_float64(renders):
    x, got, _ = renders
    for i in range(3):
        ref = _float64(x[i], {k: v[i] for k, v in PARAMS.items()})
        assert np.abs(got[i] - ref).max() / np.abs(ref).max() <= 5e-4


@pytest.mark.parametrize("T_,ranges", [
    (16384, {}), (262144, {}), (262144, {"max_room_scale": 50.0}),
    (8192, {"max_room_scale": 10.0, "max_pre_delay": 0.0}),
])
def test_sox_reverb_fft_size_equals_jax(monkeypatch, T_, ranges):
    """The n_fft JAX's ``make`` hands its ``_render_fft``, captured there."""
    seen = []

    def capture(x, *args):  # (..., sample_rate, n_fft), positionally
        seen.append(args[-1])
        return x

    monkeypatch.setattr(jsox, "_render_fft", capture)
    jeff = jsox.make(SR, **ranges)
    jeff.render(jnp.zeros((1, T_), jnp.float32), _row(PARAMS, 0))
    assert seen == [tsox.fft_size(T_, {**tsox.DEFAULT_RANGES, **ranges}, SR)]
    if not ranges:
        assert seen == [2 ** 21]


def test_sox_reverb_wet_dry_zero_is_the_identity():
    x = torch.from_numpy(_audio(rows=2, C=2, T=4096))
    eff = make_effect("sox_reverb", SR, device="cpu", max_room_scale=50.0)
    p = eff.sample_params(torch.Generator().manual_seed(1), 2)
    p["wet_dry"] = torch.zeros(2)
    assert torch.equal(eff.render_batch(x, p), x)


def test_sox_reverb_adds_a_tail_that_decays():
    """As the JAX package's test_sox_reverb_runs_and_decays: an impulse
    leaves energy in samples 5000-20000; then it falls from window to
    window."""
    eff = make_effect("sox_reverb", SR, device="cpu", max_room_scale=50.0)
    p = {"reverberance": 60.0, "high_freq_damping": 50.0, "room_scale": 40.0,
         "stereo_depth": 50.0, "wet_dry": 1.0, "pre_delay": 20.0}
    imp = torch.zeros(1, 96000)
    imp[0, 100] = 1.0
    y = eff.render(imp, p)[0].numpy()
    assert np.isfinite(y).all()
    assert np.abs(y[5000:20000]).max() > 1e-4
    rms = [np.sqrt(np.mean(y[s:s + 12000] ** 2)) for s in range(12000, 96000, 12000)]
    assert all(b < a for a, b in zip(rms, rms[1:])), rms


def test_sox_reverb_batch_equals_per_example_render():
    """Per-row room sizes give per-row lengths in one batched render."""
    x = torch.from_numpy(_audio(rows=3, T=4096))
    eff = make_effect("sox_reverb", SR, device="cpu", max_room_scale=50.0)
    p = {k: torch.tensor(v) for k, v in PARAMS.items()}
    p["room_scale"] = torch.tensor([50.0, 25.0, 5.0])
    batch = eff.render_batch(x, p)
    for i in range(3):
        one = eff.render(x[i], {k: v[i] for k, v in p.items()})
        assert (one - batch[i]).abs().max() <= 1e-6 * x.abs().max()


def test_sox_reverb_draws_every_parameter_in_its_range():
    eff = make_effect("sox_reverb", SR, device="cpu")
    p = eff.sample_params(torch.Generator().manual_seed(0), 256)
    assert list(p) == list(tsox.PARAMS)  # stereo_depth drawn, though unused
    for k, v in p.items():
        lo, hi = tsox.DEFAULT_RANGES[f"min_{k}"], tsox.DEFAULT_RANGES[f"max_{k}"]
        assert float(v.min()) >= lo and float(v.max()) < hi
    assert tsox.DEFAULT_RANGES == jsox.DEFAULT_RANGES
    assert math.isclose(tsox._A, jsox._A) and math.isclose(tsox._B, jsox._B)
