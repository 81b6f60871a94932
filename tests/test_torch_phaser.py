"""The port's phaser (``fx/phaser.py``, its recurrence in ``ops/phaser.py``)
against the JAX package's ``remfx_tpu/fx/phaser.py`` and a float64 loop.

On the CPU the recurrence runs in ``phaser_plain``, the plain version that
the CUDA kernel (``csrc/phaser.cu``) equals bit for bit on the card
(``tests/test_torch_cuda.py``). Tolerances, of the reference's peak:

  * against JAX's ``_render`` (its ``lax.scan``), at T = 4096 with the
    range's ends: 1e-5 (measured 7.8e-7 mono, 9.5e-7 stereo). Both form the
    coefficient in fp32 by the same ops; XLA's CPU ``sin`` / ``tan`` /
    ``exp`` differ from PyTorch's by ulps (ROADMAP §C: up to 1.5e-5 in
    ``sin`` at 100-140 rad, where the chorus's LFO runs; here the LFO's
    argument stays below 2.7 rad), and XLA may fuse the all-pass update
    into FMAs where the port rounds every product and sum;
  * against a float64 loop of ``_render``'s ``step``: 1e-5 (fp32 rounding
    of the coefficient and of six all-passes with feedback 0.6; measured
    5.0e-7 mono, 7.7e-7 stereo);
  * ``mix = 0`` is the identity bit for bit: ``1 * x + 0 * wet``.

The split kernel's algorithm (``phaser_chunked_plain``, the CPU model of
its three passes: chunk maps, the prefix scan of each warp's 32 maps, the
scan over groups, the rerun) on the hard rows: the slowest poles (rate
0.25 Hz, depth 0.6, feedback 0.6, from sample 140000 of the LFO, where
``a`` dwells near -0.9968 and each all-pass has a pole at z = 0.9968), and
digital silence after a loud burst; T in {1, L - 1, L, 5L + 3, 33L + 5}
(33L + 5: two groups, so the scan over groups runs) at L = 128 and 256.
Tolerances, of each row's peak:

  * against ``phaser_plain``: ``SPLIT_TOL`` = 1e-5 (measured at most
    2.0e-6 here; 2.1e-6 at 8 x 2 x 262144 on the same poles);
  * against the float64 loop from the same start: 1e-5 (measured at most
    5.4e-6; ``phaser_plain`` itself 4.7e-6: near the pole the fp32
    coefficient's rounding dominates).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx import phaser as jph
from remfx_tpu_torch.fx import make_effect
from remfx_tpu_torch.fx import phaser as tph
from remfx_tpu_torch.ops import phaser as ops_phaser
from remfx_tpu_torch.ops.phaser import (N_STAGES, SPLIT_TOL, phaser, phaser_chunked_plain,
                                        phaser_plain, phaser_serial)

torch.set_num_threads(2)
SR = 48000
T = 4096
NAMES = ("rate_hz", "depth", "centre_frequency_hz", "feedback", "mix")
# the range's ends: rate 5 Hz, depth 0.6, feedback 0.6 in row 0; the
# minima in row 1; the centre frequency is the minimum (the reference's bug)
PARAMS = {"rate_hz": [5.0, 0.25], "depth": [0.6, 0.1],
          "centre_frequency_hz": [200.0, 200.0], "feedback": [0.6, 0.1],
          "mix": [0.7, 0.1]}


def _audio(rows, C, T=T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    x *= np.linspace(0.2, 1.0, T, dtype=np.float32)
    return (0.6 * x / np.abs(x).max()).astype(np.float32)


def _torch_params(p):
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}


def _jax(x, p):
    return np.stack([np.asarray(jph._render(
        jnp.asarray(x[i]), *(np.float32(p[k][i]) for k in NAMES), SR))
        for i in range(x.shape[0])])


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _float64_loop(x, p, start=0):
    """``_render`` in float64: the coefficient, then the scan's ``step``;
    the LFO from sample ``start``."""
    B, C, T = x.shape
    f_lo, f_hi = 20.0, 0.49 * SR
    col = {k: np.asarray(v, np.float64)[:, None] for k, v in p.items()}
    n = np.arange(start, start + T, dtype=np.float64)
    lfo = np.sin(2.0 * np.pi * col["rate_hz"] * n / SR)
    norm = np.clip(np.log(col["centre_frequency_hz"] / f_lo) / np.log(f_hi / f_lo)
                   + 0.5 * col["depth"] * lfo, 0.0, 1.0)
    tant = np.tan(np.pi * f_lo * np.exp(norm * np.log(f_hi / f_lo)) / SR)
    a = ((tant - 1.0) / (tant + 1.0))[:, None, :]  # (B, 1, T)
    x64 = x.astype(np.float64)
    fb = col["feedback"][:, :, None][..., 0]
    xs = np.zeros((N_STAGES, B, C))
    ys = np.zeros((N_STAGES, B, C))
    last = np.zeros((B, C))
    wet = np.zeros_like(x64)
    for t in range(T):
        u = x64[:, :, t] + fb * last
        for s in range(N_STAGES):
            y = a[:, :, t] * u + xs[s] - a[:, :, t] * ys[s]
            xs[s], ys[s], u = u, y, y
        last = u
        wet[:, :, t] = u
    mix = col["mix"][:, :, None]
    return (1.0 - mix) * x64 + mix * wet


@pytest.fixture(scope="module")
def renders():
    """Per channel count: (input, the port's render, JAX's render)."""
    out = {}
    for C in (1, 2):
        x = _audio(2, C, seed=C)
        got = tph.render(torch.from_numpy(x), _torch_params(PARAMS), SR).numpy()
        out[C] = (x, got, _jax(x, PARAMS))
    return out


@pytest.mark.parametrize("C", [1, 2])
def test_phaser_matches_jax(renders, C):
    x, got, want = renders[C]
    assert got.shape == x.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("C", [1, 2])
def test_phaser_matches_a_float64_loop(renders, C):
    x, got, _ = renders[C]
    assert _rel(got, _float64_loop(x, PARAMS)) <= 1e-5


def test_phaser_mix_zero_is_the_identity():
    x = _audio(2, 2)
    p = _torch_params({**PARAMS, "mix": [0.0, 0.0]})
    got = tph.render(torch.from_numpy(x), p, SR).numpy()
    np.testing.assert_array_equal(got, x)


def test_phaser_keeps_the_reference_centre_frequency_bug():
    ranges = dict(jph.DEFAULT_RANGES)
    lo = ranges["min_centre_frequency_hz"]
    assert ranges == tph.DEFAULT_RANGES and ranges["max_centre_frequency_hz"] > lo
    jdraws = [float(jph.sample_params(k, SR, ranges)["centre_frequency_hz"])
              for k in jax.random.split(jax.random.PRNGKey(0), 8)]
    tdraws = make_effect("phaser", SR, device="cpu").sample_params(
        torch.Generator().manual_seed(0), 64)
    assert jdraws == [lo] * 8
    assert torch.all(tdraws["centre_frequency_hz"] == lo)
    # the other parameters do spread over their ranges
    assert torch.unique(tdraws["rate_hz"]).numel() == 64
    assert set(tdraws) == set(NAMES)


def test_phaser_wrapper_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(_audio(3, 2, T=257))
    a = tph.coefficients(_torch_params({k: v + [v[0]] for k, v in PARAMS.items()}),
                         257, SR, "cpu")
    fb, mix = torch.tensor([0.6, 0.1, 0.3]), torch.tensor([0.7, 0.1, 0.5])
    before = phaser.launches
    assert torch.equal(phaser(x, a, fb, mix), phaser_plain(x, a, fb, mix))
    assert phaser.launches == before  # the CPU launches no kernel
    with pytest.raises(ValueError, match="a must be"):
        phaser(x, a[:, :-1].contiguous(), fb, mix)
    with pytest.raises(TypeError, match="float32"):
        phaser(x.double(), a, fb, mix)
    with pytest.raises(ValueError, match="contiguous"):
        phaser(x.transpose(0, 1).contiguous().transpose(0, 1), a, fb, mix)
    with pytest.raises(ValueError, match="no phaser kernel"):
        phaser(x.to("meta"), a.to("meta"), fb.to("meta"), mix.to("meta"))


def test_phaser_batch_render_equals_per_example_render():
    x = torch.from_numpy(_audio(2, 2, T=1024))
    eff = make_effect("phaser", SR, device="cpu")
    p = eff.sample_params(torch.Generator().manual_seed(3), 2)
    batch = eff.render_batch(x, p)
    for i in range(2):
        one = eff.render(x[i], {k: v[i] for k, v in p.items()})
        assert torch.equal(one, batch[i])


# ------------------------------------------------- the split kernel's algorithm

SLOW = {"rate_hz": [0.25, 0.25], "depth": [0.6, 0.6],
        "centre_frequency_hz": [200.0, 200.0], "feedback": [0.6, 0.6],
        "mix": [0.7, 0.7]}
DWELL = 140000  # the LFO's sample where the slowest poles begin


def _hard_rows(T):
    """Two examples x 2 channels on the slowest poles: noise throughout, and
    a loud burst (the first 200 samples) then digital silence."""
    x = _audio(2, 2, T=T, seed=7)
    x[0] = np.random.default_rng(8).standard_normal((2, T)).astype(np.float32) * 0.5
    x[1, :, 200:] = 0.0
    a = tph.coefficients(_torch_params(SLOW), DWELL + T, SR, "cpu")[:, DWELL:].contiguous()
    return torch.from_numpy(x), a


def _row_rel(got, want):
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / peak).max())


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("n", ["1", "L-1", "L", "5L+3", "33L+5"])
def test_chunked_model_on_the_hard_rows(L, n):
    T = {"1": 1, "L-1": L - 1, "L": L, "5L+3": 5 * L + 3, "33L+5": 33 * L + 5}[n]
    x, a = _hard_rows(T)
    fb, mix = torch.tensor(SLOW["feedback"]), torch.tensor(SLOW["mix"])
    if T > 1000:
        assert float(a.max()) < -0.9967  # the dwell: a pole at z > 0.9967
    got = phaser_chunked_plain(x, a, fb, mix, chunk=L).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert _row_rel(got, phaser_plain(x, a, fb, mix).numpy()) <= SPLIT_TOL
    assert _row_rel(got, _float64_loop(x.numpy(), SLOW, start=DWELL)) <= 1e-5


def test_chunked_model_at_the_range_ends_matches_jax(renders):
    """The algorithm on ``renders``' rows, against the JAX package's scan."""
    x, _, want = renders[2]
    p = _torch_params(PARAMS)
    a = tph.coefficients(p, T, SR, "cpu")
    got = phaser_chunked_plain(torch.from_numpy(x), a, p["feedback"], p["mix"]).numpy()
    assert _rel(got, want) <= 1e-5


def test_phaser_serial_on_the_cpu_is_the_plain_version():
    x, a = _hard_rows(300)
    fb, mix = torch.tensor([0.6, 0.2]), torch.tensor([0.7, 0.3])
    before = phaser_serial.launches, phaser.launches
    assert torch.equal(phaser_serial(x, a, fb, mix), phaser_plain(x, a, fb, mix))
    assert (phaser_serial.launches, phaser.launches) == before
    with pytest.raises(ValueError, match="no phaser kernel"):
        phaser_serial(x.to("meta"), a.to("meta"), fb.to("meta"), mix.to("meta"))


def test_the_wrapper_mirrors_the_kernel_constants():
    """The wrapper sizes the kernel's scratch by CHUNK, GROUP, _MAP and
    _START; csrc/phaser.cu compiles them in."""
    src = (Path(ops_phaser.__file__).parents[1] / "csrc" / "phaser.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWarp") == ops_phaser.GROUP and const("kChunk") == ops_phaser.CHUNK
    assert const("kStart") == ops_phaser._START
    assert const("kStages") == N_STAGES and ops_phaser._MAP == 7 * 7 + 7
