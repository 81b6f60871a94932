"""The port's effects against the JAX package and the C++ oracle's golden
outputs, with explicit parameters per row (the two packages' random
generators differ).

The JAX side renders one example at a time through its public ``render``
(the compressor and the limiter through the scan ``envelope_scan``, as
its own CPU tests run them); the port renders the batch ``(B, C, T)`` on
the CPU (its plain envelope). Tolerances, of the JAX output:

  * stereo widener, volume automation: 1e-6 absolute (the same
    elementwise fp32 ops);
  * distortion: the port within 2 ulps of a float64 reference, and
    within 2e-6 absolute of JAX, whose ``tanh`` is XLA's approximation
    (the measurements are beside the test);
  * compressor, limiter: 1e-5 x the peak (the same fp32 recurrence,
    rounded in another order);
  * delay, reverb (mono and stereo), parametric EQ: 1e-4 x the peak (the
    JAX package's fp32 DFT-as-matmul against pocketfft's FFT);
  * chorus: 1e-4 x the peak. XLA's CPU ``sin`` of the LFO is off by up
    to 1.5e-5 at 4 Hz over 5.5 s (its argument also rounds otherwise),
    where the port forms the delay in float64 and rounds it once; the JAX
    delay moves by up to 0.5 * depth * centre * 1.5e-5 samples and the
    interpolated taps with it (measured: 4.3e-5 at 4 Hz and depth 0.6,
    1.4e-5 at 1.5 Hz);
  * the FFT helpers of ``ops/fft.py`` and ``ops/fftfilt.py``: 1e-5 x the
    peak (one transform; responses are elementwise fp32), but 1e-4 for
    ``delay_response``, a cosine of angles up to 117 rad (XLA's ``cos``,
    as above).

Against ``tests/fixtures/golden_dsp.npz`` the tolerances are those of
``tests/test_golden_fixtures.py``: absolute 2e-6 (distortion), 1e-4
(compressor, limiter), 2e-4 (delay, chorus), 5e-4 (reverb).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx import make_effect as j_make_effect
from remfx_tpu.fx import compressor as jcomp
from remfx_tpu.fx import distortion as jdist
from remfx_tpu.fx import dynamics as jdyn
from remfx_tpu.ops import fft as jfft
from remfx_tpu.ops import fftfilt as jfftfilt
from remfx_tpu_torch.fx import make_effect
from remfx_tpu_torch.fx import compressor as tcomp
from remfx_tpu_torch.fx import chorus as tchorus
from remfx_tpu_torch.fx import delay as tdelay
from remfx_tpu_torch.fx import distortion as tdist
from remfx_tpu_torch.fx import dynamics as tdyn
from remfx_tpu_torch.fx import reverb as treverb
from remfx_tpu_torch.ops import fft as tfft
from remfx_tpu_torch.ops import fftfilt as tfftfilt

torch.set_num_threads(2)
SR = 48000
B, T = 3, 8192
FIX = Path(__file__).parent / "fixtures" / "golden_dsp.npz"
# narrower maxima than the dataset's keep the JAX side's DFT-as-matmul at
# 2^18 points: reverb tail 139,456 samples, delay 172,800
REVERB_RANGES = {"max_room_size": 0.5}
DELAY_RANGES = {"max_delay_sconds": 0.3, "max_feedback": 0.3}


def _audio(C=1, seed=0, rows=B, T=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    x = np.apply_along_axis(lambda v: np.convolve(v, np.ones(8) / 8.0, "same"), -1, x)
    x *= np.linspace(0.2, 1.0, T)
    return (0.6 * x / np.abs(x).max()).astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_rows(render, x, params):
    """JAX's single-example render over the rows of ``x``."""
    return np.stack([
        np.asarray(render(jnp.asarray(x[i]),
                          {k: jnp.asarray(v[i]) for k, v in params.items()}))
        for i in range(x.shape[0])])


def _port(render, x, params):
    return render(torch.from_numpy(x),
                  {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}).numpy()


def _f32(**kw):
    return {k: np.asarray(v, np.float32) for k, v in kw.items()}


# ------------------------------------------------------- elementwise effects

# The port's distortion against a float64 reference, in units in the last
# place (ulps) of the reference rounded to float32: an fp32 product
# (0.5 ulp) and a tanh of at most 1 ulp (measured: 1.39 ulps).
DIST_PORT_ULPS = 2.0
# JAX against the port: the JAX package's own tolerance for its distortion
# against the C++ oracle (tests/test_golden_fixtures.py, 2e-6 absolute).
# XLA's fp32 tanh is a rational approximation whose error depends on the
# instruction set XLA compiles for. Measured on 14.4 million float32
# inputs in [2^-8, 16): up to 4.64 ulps (2.8e-7) with AVX-512 or AVX2, up
# to 6.42 ulps (3.8e-7) with --xla_cpu_max_isa=SSE4_2; on this test's data
# 4.09 ulps (2.2e-7), where the port is 1.39 ulps (5.3e-8) from float64.
# On another machine the two sides differed by more than the 1e-6 this
# test held before; the message names each side's error against float64.
DIST_JAX_ATOL = 2e-6


def test_distortion_matches_jax():
    x = _audio()
    p = _f32(drive_db=[8.0, 16.5, 25.0])
    want = _jax_rows(lambda v, q: jdist.render(v, q, SR), x, p)
    got = _port(lambda v, q: tdist.render(v, q, SR), x, p)
    gain32 = (10.0 ** (torch.from_numpy(p["drive_db"]) / 20.0)).numpy()
    ref = np.tanh(x.astype(np.float64) * gain32.astype(np.float64)[:, None, None])
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    port_err, jax_err = np.abs(got - ref), np.abs(want - ref)
    report = (f"against float64: port {port_err.max():.3g} "
              f"({(port_err / ulp).max():.2f} ulps), JAX {jax_err.max():.3g} "
              f"({(jax_err / ulp).max():.2f} ulps); "
              f"|JAX - port| {np.abs(got - want).max():.3g}")
    assert (port_err / ulp).max() <= DIST_PORT_ULPS, report
    assert np.abs(got - want).max() <= DIST_JAX_ATOL, report


def test_stereo_widener_matches_jax():
    x = _audio(C=2)
    p = _f32(width=[0.0, 0.37, 1.0])
    want = _jax_rows(lambda v, q: jdyn.widener_render(v, q, SR), x, p)
    got = _port(lambda v, q: tdyn.widener_render(v, q, SR), x, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_volume_automation_matches_jax():
    x = _audio()
    p = {"num_segments": np.array([1, 2, 3], np.int32),
         "fractions": np.array([[1.0, 0.0, 0.0], [0.3, 0.7, 0.0],
                                [0.2, 0.5, 0.29]], np.float32),  # row 2: a tail
         "end_gains_db": np.array([[-6.0, 2.0, 5.0], [3.0, -4.5, 1.0],
                                   [6.0, -6.0, 0.5]], np.float32)}
    want = _jax_rows(lambda v, q: jdyn.volume_render(v, q, SR), x, p)
    got = _port(lambda v, q: tdyn.volume_render(v, q, SR), x, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -------------------------------------------------------- dynamics on the envelope

def test_compressor_effect_matches_jax_render_batch():
    x = _audio()
    p = _f32(threshold_db=[-42.0, -30.0, -20.0], ratio=[1.5, 4.0, 6.0],
             attack_ms=[1.0, 5e-4, 50.0], release_ms=[10.0, 100.0, 250.0])
    want = np.asarray(jcomp.render_batch(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, SR))
    eff = make_effect("compressor", SR, device="cpu")
    got = _port(eff.render_batch, x, p)
    assert _rel(got, want) <= 1e-5


def test_limiter_matches_jax():
    x = 3.0 * _audio()  # peaks past 1: the hard clip acts
    p = _f32(threshold_db=[-32.0, -15.0, -6.0], release_ms=[10.0, 120.0, 300.0])
    want = _jax_rows(lambda v, q: jdyn.limiter_render(v, q, SR), x, p)
    got = _port(lambda v, q: tdyn.limiter_render(v, q, SR), x, p)
    assert _rel(got, want) <= 1e-5


def test_limiter_stage_two_has_zero_attack_coefficient():
    cte = tcomp.ballistics_cte(torch.tensor([0.001], dtype=torch.float32), SR)
    assert cte.item() == 0.0


# ---------------------------------------------------------- FFT effects

@pytest.mark.parametrize("C", [1, 2])
def test_delay_matches_jax(C):
    x = _audio(C=C)
    p = _f32(delay_seconds=[0.1, 0.1737, 0.3], feedback=[0.05, 0.2, 0.3],
             mix=[0.1, 0.25, 0.35])
    want = _jax_rows(j_make_effect("delay", SR, **DELAY_RANGES).render, x, p)
    got = _port(make_effect("delay", SR, device="cpu", **DELAY_RANGES).render_batch,
                x, p)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("C", [1, 2])
def test_reverb_matches_jax(C):
    x = _audio(C=C)
    p = _f32(room_size=[0.3, 0.42, 0.5], damping=[0.2, 0.6, 1.0],
             wet_dry=[0.2, 0.4, 0.6], width=[0.2, 0.5, 1.0])
    want = _jax_rows(j_make_effect("reverb", SR, **REVERB_RANGES).render, x, p)
    got = _port(make_effect("reverb", SR, device="cpu", **REVERB_RANGES).render_batch,
                x, p)
    assert _rel(got, want) <= 1e-4


def test_parametric_eq_matches_jax():
    x = _audio()
    p = _f32(low_shelf_gain_db=[-6.0, 2.0, 6.0], low_shelf_cutoff_freq=[20.0, 80.0, 200.0],
             low_shelf_q_factor=[0.1, 0.7, 4.0], high_shelf_gain_db=[6.0, -3.0, -6.0],
             high_shelf_cutoff_freq=[8000.0, 11000.0, 16000.0],
             high_shelf_q_factor=[4.0, 1.0, 0.1],
             band_gains_db=[[-6.0, 0.5, 6.0], [3.0, -2.0, 1.0], [6.0, 6.0, -6.0]],
             band_cutoff_freqs=[[1000.0, 3000.0, 10000.0], [1500.0, 1600.0, 9000.0],
                                [2000.0, 5000.0, 7000.0]],
             band_q_factors=[[0.1, 2.0, 4.0], [0.5, 0.5, 0.5], [4.0, 0.1, 1.0]])
    want = _jax_rows(j_make_effect("parametric_eq", SR).render, x, p)
    got = _port(make_effect("parametric_eq", SR, device="cpu").render_batch, x, p)
    assert _rel(got, want) <= 1e-4


def test_chorus_matches_jax():
    x = _audio()
    p = _f32(rate_hz=[0.25, 1.5, 4.0], depth=[0.0, 0.33, 0.6],
             centre_delay_ms=[5.0, 7.5, 10.0], feedback=[0.1, 0.4, 0.6],
             mix=[0.1, 0.4, 0.7])
    want = _jax_rows(j_make_effect("chorus", SR).render, x, p)
    got = _port(make_effect("chorus", SR, device="cpu").render_batch, x, p)
    assert _rel(got, want) <= 1e-4


def test_chorus_chunk_is_128_at_the_dataset_ranges():
    from remfx_tpu_torch.config.core import default_effect_overrides
    ranges = {**tchorus.DEFAULT_RANGES, **default_effect_overrides()["chorus"]}
    assert tchorus.chunk_size(ranges, SR) == 128
    with pytest.raises(ValueError):
        tchorus.chunk_size({**ranges, "min_centre_delay_ms": 0.1}, SR)


@pytest.mark.parametrize("ranges,n_fft", [
    ({}, 2 ** 21),  # all.yaml's max room size 1.0: tail 1,203,567
    ({"max_room_size": 0.5}, 2 ** 19),
])
def test_reverb_fft_size_at_full_width(ranges, n_fft):
    pad = treverb.tail_samples({**treverb.DEFAULT_RANGES, **ranges}["max_room_size"], SR)
    assert 1 << int(262144 + pad - 1).bit_length() == n_fft
    if not ranges:
        assert pad == 1203567


def test_delay_fft_size_at_full_width():
    pad = tdelay.tail_samples(1.0, 0.3, SR)  # all.yaml's maxima
    assert pad == 576000
    assert 1 << int(262144 + pad - 1).bit_length() == 2 ** 20


# ------------------------------------------------ the batch and one example

EFFECTS = ["distortion", "compressor", "limiter", "delay", "reverb", "chorus",
           "parametric_eq", "volume_automation", "stereo_widener"]
OVERRIDES = {"delay": DELAY_RANGES, "reverb": REVERB_RANGES}


@pytest.mark.parametrize("name", EFFECTS)
def test_batch_render_equals_per_example_render(name):
    """``RandomEffect.render`` is the batch render at B = 1 (1e-6 x the
    peak: a transform of one row against the same row in a batch)."""
    C = 2 if name == "stereo_widener" else 1
    x = torch.from_numpy(_audio(C=C, T=4096))
    eff = make_effect(name, SR, device="cpu", **OVERRIDES.get(name, {}))
    params = eff.sample_params(torch.Generator().manual_seed(3), B)
    batch = eff.render_batch(x, params)
    assert batch.shape == x.shape and torch.isfinite(batch).all()
    for i in range(B):
        one = eff.render(x[i], {k: v[i] for k, v in params.items()})
        assert (one - batch[i]).abs().max() <= 1e-6 * batch[i].abs().max()


@pytest.mark.parametrize("name", EFFECTS)
def test_sample_params_seeded_and_in_range(name):
    eff = make_effect(name, SR, device="cpu")
    p = eff.sample_params(torch.Generator().manual_seed(0), 64)
    q = eff.sample_params(torch.Generator().manual_seed(0), 64)
    for k, v in p.items():
        assert v.shape[0] == 64 and torch.equal(v, q[k])
        lo = eff.ranges.get(f"min_{k}")
        hi = eff.ranges.get("max_delay_sconds" if k == "delay_seconds" else f"max_{k}")
        if lo is not None:  # fp32 draws: within an ulp of the range
            assert lo - 1e-6 * abs(lo) <= v.min() and v.max() <= hi + 1e-6 * abs(hi)


def test_volume_fractions_are_dirichlet_over_the_active_segments():
    eff = make_effect("volume_automation", SR, device="cpu")
    p = eff.sample_params(torch.Generator().manual_seed(1), 512)
    n, fr = p["num_segments"], p["fractions"]
    assert set(n.tolist()) == {1, 2, 3}
    assert torch.isfinite(fr).all()
    active = torch.arange(3)[None, :] < n[:, None]
    assert torch.all(fr[~active] == 0.0)  # exactly zero, not tiny
    assert torch.all(fr >= 0.0)
    torch.testing.assert_close(fr.sum(-1), torch.ones(512), rtol=0, atol=1e-6)


def test_registry():
    """Every name of the JAX registry builds, ``phaser`` and ``sox_reverb``
    included (held to JAX in test_torch_phaser.py / test_torch_sox_reverb.py)."""
    for name in ("phaser", "sox_reverb"):
        eff = make_effect(name, SR, device="cpu")
        assert eff.name == name and eff.ranges == j_make_effect(name, SR).ranges
        x = torch.from_numpy(_audio(rows=2, T=1024))
        y = eff(torch.Generator().manual_seed(0), x)
        assert y.shape == x.shape and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError):
        make_effect("flanger", SR, device="cpu")
    eff = make_effect("delay", SR, device="cpu", max_delay_sconds=0.5)
    assert eff.ranges["max_delay_sconds"] == 0.5 and eff.name == "delay"


def test_effects_default_to_the_card():
    if torch.cuda.is_available():
        assert make_effect("distortion", SR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_effect("distortion", SR)


# ------------------------------------------------ ops/fft.py and ops/fftfilt.py

@pytest.mark.parametrize("n", [1024, 8192])  # the JAX direct and 4-step paths
def test_rfft_irfft_match_jax(n):
    x = _audio(rows=2, T=n - 100)[:, 0]
    jre, jim = (np.asarray(v) for v in jfft.rfft_ri(jnp.asarray(x), n))
    tre, tim = tfft.rfft_ri(torch.from_numpy(x), n)
    scale = np.abs(np.concatenate([jre, jim])).max()
    assert np.abs(tre.numpy() - jre).max() / scale <= 1e-5
    assert np.abs(tim.numpy() - jim).max() / scale <= 1e-5
    # a spectrum with imaginary parts at DC and Nyquist: both ignore them
    rng = np.random.default_rng(1)
    re = rng.standard_normal((2, n // 2 + 1)).astype(np.float32)
    im = rng.standard_normal((2, n // 2 + 1)).astype(np.float32)
    want = np.asarray(jfft.irfft_ri(jnp.asarray(re), jnp.asarray(im), n))
    got = tfft.irfft_ri(torch.from_numpy(re), torch.from_numpy(im), n).numpy()
    assert _rel(got, want) <= 1e-5


def test_cmul_cdiv_match_jax():
    rng = np.random.default_rng(2)
    a, b, c, d = (rng.standard_normal(64).astype(np.float32) for _ in range(4))
    for jf, tf in ((jfft.cmul, tfft.cmul), (jfft.cdiv, tfft.cdiv)):
        want = jf(*(jnp.asarray(v) for v in (a, b, c, d)))
        got = tf(*(torch.from_numpy(v) for v in (a, b, c, d)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_fftfilt_matches_jax():
    n_fft = 4096
    jz = jfftfilt.rfft_omega(n_fft)
    tz = tfftfilt.rfft_omega(n_fft)
    for g, w in zip(tz, jz):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    b = np.array([[0.9, -1.7, 0.8], [1.0, 0.3, 0.1]], np.float32)
    a = np.array([[1.0, -1.6, 0.7], [1.0, -0.2, 0.05]], np.float32)
    want = jfftfilt.cascade_response_ri([jnp.asarray(b)], [jnp.asarray(a)], *jz)
    got = tfftfilt.cascade_response_ri([torch.from_numpy(b)], [torch.from_numpy(a)], *tz)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
    # angles up to 117 rad, where XLA's CPU cos / sin are off by up to
    # 1.5e-5 (torch's by 4e-8): 1e-4 absolute
    want = jfftfilt.delay_response(*jz, jnp.float32(37.25))
    got = tfftfilt.delay_response(*tz, torch.tensor(37.25))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4
    x = _audio(rows=2, T=2000)[:, 0]
    Hr, Hi = (np.array(v) for v in jfftfilt.biquad_response_ri(
        jnp.asarray(b), jnp.asarray(a), *jz))
    want = np.asarray(jfftfilt.apply_lti_ri(jnp.asarray(x), jnp.asarray(Hr),
                                            jnp.asarray(Hi), n_fft))
    got = tfftfilt.apply_lti_ri(torch.from_numpy(x), torch.from_numpy(Hr),
                                torch.from_numpy(Hi), n_fft).numpy()
    assert _rel(got, want) <= 1e-5
    assert tfftfilt.next_pow2(262145) == jfftfilt.next_pow2(262145) == 2 ** 19


# ------------------------------------------------------------ golden outputs

@pytest.fixture(scope="module")
def golden():
    return np.load(FIX)


def _cases(golden, effect):
    idxs = sorted({k.split("/")[1] for k in golden.files if k.startswith(f"{effect}/")})
    for i in idxs:
        params = {k.split("/param/")[1]: float(golden[k]) for k in golden.files
                  if k.startswith(f"{effect}/{i}/param/")}
        yield params, golden[f"{effect}/{i}/output"]


def _golden_params(effect, params):
    """The fixture's parameter names -> the port's, as in
    tests/test_golden_fixtures.py; -> (effect kwargs, params)."""
    if effect == "chorus":
        params = {**params, "centre_delay_ms": params.pop("centre_ms")}
    if effect == "reverb":
        params = {"room_size": params["room_size"], "damping": params["damping"],
                  "wet_dry": params["wet_level"], "width": params["width"]}
        return {"max_room_size": max(0.5, params["room_size"])}, params
    if effect == "delay":
        return {"max_delay_sconds": 0.3}, params
    return {}, params


GOLDEN_TOL = {"distortion": 2e-6, "compressor": 1e-4, "limiter": 1e-4,
              "delay": 2e-4, "chorus": 2e-4, "reverb": 5e-4}


@pytest.mark.parametrize("effect", list(GOLDEN_TOL))
def test_effect_matches_golden_fixtures(golden, effect):
    x = torch.from_numpy(golden["input"][None])
    n = 0
    for params, ref in _cases(golden, effect):
        kw, params = _golden_params(effect, params)
        eff = make_effect(effect, SR, device="cpu", **kw)
        y = eff.render(x, {k: torch.tensor(v, dtype=torch.float32)
                           for k, v in params.items()})[0].numpy()
        assert np.abs(y - ref).max() < GOLDEN_TOL[effect], params
        n += 1
    assert n >= 2
