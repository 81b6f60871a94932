"""The port's biquads and BS.1770 loudness against the JAX package,
float64 ``scipy.signal.lfilter`` and a float64 BS.1770 reference.

The port runs the biquad recurrence in float64 (``ops/biquad.py``). The
JAX package runs it as an fp32 ``associative_scan``, which loses filters
with poles near |z| = 1: against float64 ``lfilter`` it is off by up to
1.16 x the peak for a 20 Hz low shelf, and by 91 x the peak for the
K-weighting high-pass (38 Hz) on a signal with a DC offset. Where the
JAX package is off, the port follows ``lfilter``. Tolerances:

  * ``biquad_coeffs``: 1e-6 relative (the same fp32 formulas);
  * ``biquad_filter`` against float64 ``lfilter`` of the same
    coefficients: 1e-6 x the peak (the port rounds once, to fp32);
  * ``biquad_filter`` against JAX: 1e-5 x the peak beyond the JAX
    package's own distance from ``lfilter`` (that is, the port may differ
    from JAX only by JAX's own error, plus fp32 rounding);
  * ``integrated_loudness`` against a float64 reference of the same
    algorithm (``lfilter``, the same blocks and gates): 1e-4 LU;
  * ``integrated_loudness`` against JAX: 0.05 LU, the tolerance of the
    JAX package's own test against its numpy reference
    (``tests/test_ops.py::test_lufs_matches_numpy_reference``); its fp32
    high-pass puts it 0.012-0.016 LU from float64 on 48 kHz noise;
  * ``loudness_normalize`` against JAX: 6e-3 x the peak (the gain of a
    0.05 LU difference, 10^(0.05/20) - 1 = 5.8e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from remfx_tpu.ops import biquad as jbiquad
from remfx_tpu.ops import loudness as jloud
from remfx_tpu_torch.fx.dynamics import LoudnessNormalize
from remfx_tpu_torch.ops import biquad as tbiquad
from remfx_tpu_torch.ops import loudness as tloud

torch.set_num_threads(2)
SR = 48000
# (gain dB, cutoff Hz, Q, type): the EQ's shelves and a band, and
# K-weighting's shelf
FILTERS = [(-6.0, 20.0, 0.1, "low_shelf"), (4.5, 180.0, 2.0, "low_shelf"),
           (6.0, 16000.0, 4.0, "high_shelf"), (4.0, 1500.0, 1 / np.sqrt(2), "high_shelf"),
           (-6.0, 1000.0, 0.1, "peaking"), (5.0, 9000.0, 4.0, "peaking")]


def _noise(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("gain,fc,q,kind", FILTERS)
def test_biquad_coeffs_match_jax(gain, fc, q, kind):
    jb, ja = jbiquad.biquad_coeffs(gain, fc, q, SR, kind)
    tb, ta = tbiquad.biquad_coeffs(gain, fc, q, SR, kind)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)


@pytest.mark.parametrize("gain,fc,q,kind", FILTERS)
def test_biquad_filter_matches_jax_and_lfilter(gain, fc, q, kind):
    x = _noise((2, 1, 12000))
    b, a = tbiquad.biquad_coeffs(gain, fc, q, SR, kind)
    got = tbiquad.biquad_filter(b, a, torch.from_numpy(x)).numpy()
    want = np.asarray(jbiquad.biquad_filter(jnp.asarray(b.numpy()),
                                            jnp.asarray(a.numpy()), jnp.asarray(x)))
    ref = scipy.signal.lfilter(b.double().numpy(), a.double().numpy(),
                               x.astype(np.float64), axis=-1)
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, want) <= _rel(want, ref) + 1e-5


def test_k_weighting_highpass_matches_jax_and_lfilter():
    (_, _), (jb, ja) = jloud.k_weighting_coeffs(SR)
    (_, _), (tb, ta) = tloud.k_weighting_coeffs(SR)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    x = _noise((2, 24000), seed=1) + 0.2  # a DC offset for the high-pass
    got = tbiquad.biquad_filter(tb, ta, torch.from_numpy(x)).numpy()
    want = np.asarray(jbiquad.biquad_filter(jb, ja, jnp.asarray(x)))
    ref = scipy.signal.lfilter(tb.double().numpy(), ta.double().numpy(),
                               x.astype(np.float64), axis=-1)
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, want) <= _rel(want, ref) + 1e-5


def test_per_row_coefficients_and_sosfilt():
    """Coefficients of shape (B, 3) filter each row with its own biquad;
    a cascade of two sections equals two calls."""
    x = torch.from_numpy(_noise((3, 1, 5000), seed=2))
    b, a = tbiquad.biquad_coeffs(torch.tensor([-6.0, 0.0, 6.0]),
                                 torch.tensor([100.0, 1000.0, 5000.0]),
                                 torch.tensor([0.5, 1.0, 2.0]), SR, "peaking")
    rows = tbiquad.biquad_filter(b[:, None], a[:, None], x)
    for i in range(3):
        one = tbiquad.biquad_filter(b[i], a[i], x[i])
        torch.testing.assert_close(rows[i], one, rtol=0, atol=1e-7)
    sos_b, sos_a = torch.stack([b[0], b[2]]), torch.stack([a[0], a[2]])
    want = tbiquad.biquad_filter(b[2], a[2], tbiquad.biquad_filter(b[0], a[0], x))
    torch.testing.assert_close(tbiquad.sosfilt(sos_b, sos_a, x), want, rtol=0, atol=0)
    jwant = np.asarray(jbiquad.sosfilt(jnp.asarray(sos_b.numpy()),
                                       jnp.asarray(sos_a.numpy()), jnp.asarray(x.numpy())))
    ref = x.double().numpy()
    for b_, a_ in zip(sos_b.double().numpy(), sos_a.double().numpy()):
        ref = scipy.signal.lfilter(b_, a_, ref, axis=-1)
    assert _rel(want.numpy(), ref) <= 2e-6  # rounded to fp32 between sections
    assert _rel(want.numpy(), jwant) <= _rel(jwant, ref) + 1e-5


# ------------------------------------------------------------------ loudness

LOUDNESS_CASES = {
    "noise_mono": (SR, (1, 48000)),
    "noise_stereo": (SR, (2, 30000)),
    "under_400ms": (SR, (1, 12000)),  # the ungated branch
    "rate_44k1": (44100, (1, 40000)),
    "rate_11k025": (11025, (1, 20000)),  # 0.1 s is 1102.5 samples: truncated per block
}


def bs1770_reference(x: np.ndarray, sr: int) -> float:
    """Integrated loudness of ``x (C, T)`` in float64: ``lfilter`` with the
    K-weighting coefficients, blocks starting at ``int(j * 0.1 * sr)``,
    zero-padded at the end, the two gates, and the ungated loudness below
    one block."""
    y = x.astype(np.float64)
    for b, a in tloud.k_weighting_coeffs(sr):
        y = scipy.signal.lfilter(b.double().numpy(), a.double().numpy(), y, axis=-1)
    num_blocks = int(np.round((x.shape[-1] / sr - 0.4) / 0.1)) + 1
    if num_blocks < 1:
        return -0.691 + 10 * np.log10(np.sum(np.mean(y ** 2, axis=-1)))
    L = int(0.4 * sr)
    power = np.array([np.sum(y[:, int(j * 0.1 * sr):int(j * 0.1 * sr) + L] ** 2)
                      for j in range(num_blocks)]) / (0.4 * sr)
    with np.errstate(divide="ignore"):
        l_j = -0.691 + 10 * np.log10(power)
        gamma_r = -0.691 + 10 * np.log10(power[l_j >= -70.0].mean()) - 10.0
        return -0.691 + 10 * np.log10(power[(l_j > gamma_r) & (l_j > -70.0)].mean())


@pytest.mark.parametrize("case", list(LOUDNESS_CASES))
def test_integrated_loudness_matches_reference_and_jax(case):
    sr, shape = LOUDNESS_CASES[case]
    x = _noise(shape, seed=3) * np.linspace(0.05, 1.0, shape[-1], dtype=np.float32)
    got = tloud.integrated_loudness(torch.from_numpy(x), sr).item()
    assert abs(got - bs1770_reference(x, sr)) <= 1e-4
    want = float(jloud.integrated_loudness(jnp.asarray(x), sr))
    assert np.isfinite(want) and abs(got - want) <= 0.05


def test_integrated_loudness_is_batched_and_takes_mono_1d():
    x = np.stack([_noise((1, 24000), seed=s, scale=0.1 * (s + 1)) for s in range(3)])
    got = tloud.integrated_loudness(torch.from_numpy(x), SR)
    assert got.shape == (3,)
    for i in range(3):
        assert abs(got[i].item() - bs1770_reference(x[i], SR)) <= 1e-4
    one = tloud.integrated_loudness(torch.from_numpy(x[0, 0]), SR)
    assert one.shape == () and abs(one.item() - got[0].item()) <= 1e-6


def test_silence_is_minus_inf_and_the_gain_is_clamped():
    x = np.zeros((2, 1, 24000), np.float32)
    x[1, 0, :100] = 1e-4  # a click, then digital silence: every block gated out
    got = tloud.integrated_loudness(torch.from_numpy(x), SR)
    want = [float(jloud.integrated_loudness(jnp.asarray(v), SR)) for v in x]
    assert got[0].item() == -np.inf == want[0]
    assert (got[1].item() == -np.inf) == (want[1] == -np.inf)
    y = tloud.loudness_normalize(torch.from_numpy(x), SR, -20.0)
    assert torch.equal(y[0], torch.zeros_like(y[0]))
    # the +40 dB clamp: a gain of exactly 100 on the click
    torch.testing.assert_close(y[1], 100.0 * torch.from_numpy(x[1]), rtol=1e-6, atol=0)
    jy = np.asarray(jloud.loudness_normalize(jnp.asarray(x[1]), SR, -20.0))
    np.testing.assert_allclose(y[1].numpy(), jy, rtol=1e-6, atol=0)


@pytest.mark.parametrize("target", [-20.0, -32.0])
def test_loudness_normalize_matches_jax(target):
    x = np.stack([_noise((1, 24000), seed=4, scale=s) for s in (0.01, 0.3, 0.9)])
    got = LoudnessNormalize(SR, target)(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(jloud.loudness_normalize(jnp.asarray(v), SR, target))
                     for v in x])
    assert _rel(got, want) <= 6e-3
    for v in got:
        assert abs(bs1770_reference(v, SR) - target) <= 1e-4
