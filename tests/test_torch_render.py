"""The port's chain renderer (``augment/render.py``) and its config copy.

``render_batch`` is ``draw`` (the plan: per row, which effect runs in
which slot, with its parameters) then ``apply``. The two packages' random
generators differ, so the parity test takes one plan of the port's and
has the JAX side compose the JAX package's own effect renders, in that
plan's order, row by row, with a loudness normalisation after each
effect and at the end: the kept stage from the clean clips, the removed
stage from the port's dry. Tolerances, of the JAX output's peak:

  * with the JAX package's ``loudness_normalize``: 6e-3. Its fp32
    K-weighting high-pass puts its loudness 0.012-0.016 LU from float64
    (``tests/test_torch_loudness.py``); the JAX package's own test allows
    0.05 LU, a gain of 5.8e-3;
  * with the loudness of a float64 BS.1770 reference in its place (the
    effects alone): 1e-4, the tolerance of the FFT effects.

The draw is checked statistically, as ``tests/test_augment.py`` does:
exact counts at the default config, the endpoint half-weighting of the
count draw, and label marginals of the two dispatch modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.config import core as jcore
from remfx_tpu.fx import make_effect as j_make_effect
from remfx_tpu.ops.loudness import loudness_normalize as j_normalize
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.augment import STFT_THRESH, EffectChainRenderer
from remfx_tpu_torch.config import core as tcore
from remfx_tpu_torch.ops.loudness import integrated_loudness
from tests.test_torch_loudness import bs1770_reference

torch.set_num_threads(2)
SR = 48000
T = 24000  # 0.5 s: two gating blocks
CFG = tcore.default_config()
KEEP, REMOVE = tuple(CFG["effects_to_keep"]), tuple(CFG["effects_to_remove"])
# the dataset's ranges, with narrower maxima for the reverb and the delay
# so that the JAX side's DFT-as-matmul stays at 2^18 points
OVERRIDES = {**CFG["effects"], "reverb": {**CFG["effects"]["reverb"], "max_room_size": 0.5},
             "delay": {**CFG["effects"]["delay"], "max_delay_sconds": 0.3}}


def _renderer(**kw):
    args = dict(sample_rate=SR, effects_to_keep=KEEP, effects_to_remove=REMOVE,
                num_kept_effects=CFG["num_kept_effects"],
                num_removed_effects=CFG["num_removed_effects"],
                shuffle_kept_effects=CFG["shuffle_kept_effects"],
                shuffle_removed_effects=CFG["shuffle_removed_effects"],
                effect_overrides=OVERRIDES, device="cpu")
    args.update(kw)
    return EffectChainRenderer(**args)


def _clips(rows, T=T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 1, T)).astype(np.float32)
    x *= np.linspace(0.3, 1.0, T, dtype=np.float32)
    return torch.from_numpy((0.5 * x / np.abs(x).max()).astype(np.float32))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------ the config

def test_config_copy_equals_the_jax_config():
    jcfg = jcore.default_config()
    port = tcore.default_config()
    assert {k: jcfg[k] for k in port} == port
    assert tcore.default_effect_overrides() == jcore.default_effect_overrides()
    assert port["datamodule"]["render_batch_size"] == 8 and port["chunk_size"] == 262144


# ---------------------------------------------------- apply against JAX

def _jax_stage(x, stage, normalize):
    """One stage of the plan applied row by row with the JAX package's
    renders, each followed by ``normalize``."""
    jfx = {n: j_make_effect(n, SR, **OVERRIDES.get(n, {})) for n in KEEP + REMOVE}
    out = []
    for i in range(x.shape[0]):
        y = x[i]
        for step in stage.steps:
            k = np.nonzero(step.rows == i)[0]
            if k.size:
                p = {n: jnp.asarray(v[int(k[0])].numpy()) for n, v in step.params.items()}
                y = normalize(np.asarray(jfx[step.name].render(jnp.asarray(y), p)))
        out.append(y)
    return np.stack(out)


def _exact_normalize(y):
    """Gain to -20 LUFS by the float64 reference, as the port's clamp."""
    delta = np.clip(-20.0 - bs1770_reference(y, SR), -120.0, 40.0)
    return (10.0 ** (delta / 20.0) * y).astype(np.float32)


@pytest.fixture(scope="module")
def planned():
    r = _renderer()
    x = _clips(3)
    plan = r.draw(torch.Generator().manual_seed(0), 3)
    dry, wet = r.apply(x, plan)
    return x.numpy(), plan, dry, r.normalize(dry).numpy(), r.normalize(wet).numpy()


@pytest.mark.parametrize("loudness,tol", [("jax", 6e-3), ("float64", 1e-4)])
def test_apply_matches_jax_composition(planned, loudness, tol):
    """Dry: the kept stage from the clean clips. Wet: the removed stage
    from the port's dry (so that the distortion's drive, up to 17.8x in
    its linear range, does not multiply the kept stage's differences)."""
    x, plan, dry_raw, dry, wet = planned
    normalize = (_exact_normalize if loudness == "float64"
                 else lambda y: np.asarray(j_normalize(jnp.asarray(y), SR, -20.0)))
    jdry = np.stack([normalize(y) for y in _jax_stage(x, plan.keep, normalize)])
    jwet = np.stack([normalize(y) for y in
                     _jax_stage(dry_raw.numpy(), plan.remove, normalize)])
    # every row took two kept effects and both removed ones
    assert (plan.keep.labels.sum(1) == 2).all() and (plan.remove.labels.sum(1) == 2).all()
    assert _rel(dry, jdry) <= tol
    assert _rel(wet, jwet) <= tol


# -------------------------------------------------------------- the draw

def test_default_config_draws_exact_counts():
    r = _renderer()
    plan = r.draw(torch.Generator().manual_seed(1), 256)
    keep, rem = plan.keep.labels, plan.remove.labels
    idx = [ALL_EFFECTS.index(n) for n in KEEP]
    assert (keep.sum(1) == 2).all() and (keep[:, idx].sum(1) == 2).all()
    assert (rem[:, [ALL_EFFECTS.index(n) for n in REMOVE]] == 1).all()
    assert (rem.sum(1) == 2).all()
    # the kept pairs are shuffled: every pair and both orders occur
    assert len({tuple(np.nonzero(row)[0]) for row in keep}) == 3
    first = {s.name for s in plan.keep.steps[:3]}
    assert first == set(KEEP)
    # not shuffled: the compressor runs first, on every row
    assert [s.name for s in plan.remove.steps] == ["compressor", "distortion"]
    assert all(s.rows.size == 256 for s in plan.remove.steps)


def test_count_draw_keeps_the_endpoint_half_weighting():
    """round((0 - 3) U + 3): 0 and 3 each take 1/6, 1 and 2 each 1/3."""
    r = _renderer(num_kept_effects=(0, 3), effects_to_remove=())
    n = 6000
    counts = r.draw(torch.Generator().manual_seed(2), n).keep.labels.sum(1)
    freq = np.bincount(counts.astype(int), minlength=4) / n
    np.testing.assert_allclose(freq, [1 / 6, 1 / 3, 1 / 3, 1 / 6], atol=0.025)


def test_switch_and_dense_label_marginals_agree():
    kw = dict(effects_to_keep=(), effects_to_remove=("distortion", "compressor"),
              num_kept_effects=(0, 0), num_removed_effects=(0, 2),
              shuffle_removed_effects=True, stft_check=False)
    x = _clips(48, T=4096)
    marg = {}
    for mode in ("switch", "dense"):
        _, _, dl, wl = _renderer(dispatch=mode, **kw).render_batch(
            torch.Generator().manual_seed(3), x)
        assert wl.shape == (48, 5) and dl.sum() == 0 and wl[:, :3].sum() == 0
        marg[mode] = wl.numpy().mean(0)
    # each of the two effects is on with probability 1/2 (count 0..2 with
    # half-weighted ends, shuffled): both modes within sampling error
    np.testing.assert_allclose(marg["switch"][3:], [0.5, 0.5], atol=0.2)
    np.testing.assert_allclose(marg["dense"][3:], [0.5, 0.5], atol=0.2)


# ---------------------------------------------------- rendering contract

def test_render_batch_shapes_labels_and_loudness():
    r = _renderer()
    dry, wet, dl, wl = r.render_batch(torch.Generator().manual_seed(4), _clips(3))
    assert dry.shape == wet.shape == (3, 1, T)
    assert torch.isfinite(dry).all() and torch.isfinite(wet).all()
    assert torch.equal(dl.sum(1), torch.full((3,), 2.0))
    assert torch.equal(wl[:, 3:], torch.ones(3, 2))
    for y in (dry, wet):
        assert torch.all((integrated_loudness(y, SR) + 20.0).abs() <= 1e-2)


def test_same_seed_same_output():
    r = _renderer()
    a = r.render_batch(torch.Generator().manual_seed(5), _clips(2))
    b = r.render_batch(torch.Generator().manual_seed(5), _clips(2))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_single_example_render():
    r = _renderer()
    dry, wet, dl, wl = r.render(torch.Generator().manual_seed(6), _clips(1)[0])
    assert dry.shape == wet.shape == (1, T) and dl.shape == wl.shape == (5,)
    assert dl.sum() == 2 and wl.sum() == 2


def test_zero_removed_effects_gives_wet_equal_to_dry():
    r = _renderer(num_removed_effects=(0, 0))
    dry, wet, dl, wl = r.render_batch(torch.Generator().manual_seed(7), _clips(2))
    assert torch.equal(dry, wet)
    assert wl.sum() == 0 and torch.equal(dl.sum(1), torch.full((2,), 2.0))


def test_forced_redraw_renders_only_the_failing_rows(monkeypatch):
    """Row 1 fails the MR-STFT check once: only it is drawn and rendered
    again, from its already-effected dry; rows 0 and 2 keep the first
    render bit for bit."""
    r = _renderer()
    x = _clips(3)
    first = r.render_batch(torch.Generator().manual_seed(8), x)  # no redraw here
    dists = iter([np.array([1.0, STFT_THRESH / 2, 1.0]), np.ones(3)])
    monkeypatch.setattr(r, "stft_distance", lambda a, b: next(dists))
    applied = []
    apply = r.apply
    monkeypatch.setattr(r, "apply", lambda xb, plan: applied.append(xb.shape[0])
                        or apply(xb, plan))
    again = r.render_batch(torch.Generator().manual_seed(8), x)
    assert applied == [3, 1]
    for u, v in zip(first, again):
        assert torch.equal(u[[0, 2]], v[[0, 2]])
    assert not torch.allclose(first[1][1], again[1][1])
    # the redrawn row's dry went through two more kept effects
    assert again[2][1].sum() == 2 and again[3][1].sum() == 2


def test_redraws_stop_at_max_redraws(monkeypatch):
    r = _renderer(max_redraws=2)
    calls = []
    monkeypatch.setattr(r, "stft_distance",
                        lambda a, b: calls.append(1) or np.zeros(a.shape[0]))
    r.render_batch(torch.Generator().manual_seed(9), _clips(2))
    assert len(calls) == 2


def test_renderer_checks_its_arguments():
    with pytest.raises(ValueError):
        _renderer(effects_to_keep=("flanger",))
    with pytest.raises(ValueError):
        _renderer(dispatch="pipeline")
    with pytest.raises(ValueError):
        _renderer().render_batch(torch.Generator(), _clips(2)[0])


def test_renderer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert _renderer(device=None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _renderer(device=None)
