"""The port's ``RandomAudioEffectsChannel`` (``fx/chain.py``) against the
JAX package's ``remfx_tpu/fx/chain.py``.

The JAX channel decides and draws per example with JAX keys, which the
port cannot reproduce; so the port's channel, given explicit decisions and
parameters, is held to the composition of the JAX channel's own effects,
each rendered per example through its public ``render`` where the row
drew it, in the JAX channel's order, then its ``LoudnessNormalize``.

Tolerances, of the peak of the JAX output, per row:

  * the effects: 1e-3, with both compositions normalised by the port's
    ``LoudnessNormalize`` (measured 3.7e-4 mono, 5.3e-4 stereo). The
    parametric EQ takes most of it: at T = 8192 the JAX package applies
    its response through an fp32 2^14-point DFT-as-matmul, which on these
    random draws (shelf Q up to 3.9) is up to 4.6e-4 of the peak from the
    port's float64 twin of the same render, where the port's fp32 render
    is 2.5e-7 from it. The other stages are 3e-5 or closer (delay 8e-5);
    ``test_torch_fx.py`` holds each alone at 1e-4 with milder EQ settings;
  * the whole channel, JAX's own ``LoudnessNormalize`` last: 6e-3, the
    gain of 0.05 LU, as ``test_torch_loudness.py`` holds the normaliser
    to JAX (its fp32 K-weighting scan is 0.012-0.016 LU from float64;
    ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.fx.chain import RandomAudioEffectsChannel as JChannel
from remfx_tpu_torch.fx import RandomAudioEffectsChannel
from remfx_tpu_torch.ops.loudness import integrated_loudness

torch.set_num_threads(2)
SR = 48000
B, T = 3, 8192
# per stage, the rows that render it: a strict subset or all of the rows
PATTERNS = [(1, 1, 1), (1, 0, 1), (0, 1, 0), (1, 1, 0), (0, 0, 1)]


def _audio(C, rows=B, T=T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    x = np.apply_along_axis(lambda v: np.convolve(v, np.ones(8) / 8.0, "same"), -1, x)
    x *= np.linspace(0.2, 1.0, T)
    return (0.6 * x / np.abs(x).max()).astype(np.float32)


@pytest.fixture(scope="module")
def jchannel():
    return JChannel(SR)


def _decisions(channel, C):
    return {name: torch.tensor(PATTERNS[k % len(PATTERNS)], dtype=torch.bool)
            for k, name in enumerate(channel.stages(C))}


def _jax_composition(jchannel, x, apply, params, normalize):
    out = []
    for i in range(x.shape[0]):
        y = jnp.asarray(x[i])
        for name, effect in jchannel.effects.items():
            if name == "stereo_widener" and x.shape[1] != 2:
                continue
            if bool(apply[name][i]):
                p = {k: jnp.asarray(v[i].numpy()) for k, v in params[name].items()}
                y = effect.render(y, p).astype(y.dtype)
        out.append(np.asarray(normalize(y)))
    return np.stack(out)


@pytest.mark.parametrize("C", [1, 2], ids=["mono", "stereo"])
def test_channel_equals_the_jax_effects_composed(jchannel, C):
    channel = RandomAudioEffectsChannel(SR, device="cpu")
    x = _audio(C, seed=C)
    apply = _decisions(channel, C)
    _, params = channel.sample(torch.Generator().manual_seed(C), B, C)
    got = channel.render_batch(torch.from_numpy(x), apply, params).numpy()
    effects = _jax_composition(
        jchannel, x, apply, params,
        lambda y: channel.normalize(torch.from_numpy(np.array(y))).numpy())
    want = _jax_composition(jchannel, x, apply, params, jchannel.normalize)
    assert got.shape == x.shape and np.isfinite(got).all()
    for i in range(B):
        assert np.abs(got[i] - effects[i]).max() / np.abs(effects[i]).max() <= 1e-3, i
        assert np.abs(got[i] - want[i]).max() / np.abs(want[i]).max() <= 6e-3, i
    # every stage ran on some row; the output is at the channel's loudness
    assert all(bool(a.any()) for a in apply.values())
    lufs = integrated_loudness(torch.from_numpy(got), SR)
    assert torch.allclose(lufs, torch.full_like(lufs, -32.0), atol=0.1)


def test_order_and_probabilities_equal_jax(jchannel):
    channel = RandomAudioEffectsChannel(SR, device="cpu")
    assert channel.DEFAULT_PROBS == JChannel.DEFAULT_PROBS
    assert list(channel.effects) == list(jchannel.effects)
    assert list(channel.effects) == [
        "parametric_eq", "distortion", "delay", "chorus", "phaser", "compressor",
        "reverb", "stereo_widener", "limiter", "volume_automation"]
    for name, effect in channel.effects.items():
        assert effect.ranges == jchannel.effects[name].ranges, name
    assert channel.normalize.target_lufs_db == jchannel.normalize.target_lufs_db == -32.0


def test_widener_is_skipped_on_mono():
    channel = RandomAudioEffectsChannel(SR, device="cpu", stereo_widener_prob=1.0)
    assert "stereo_widener" not in channel.stages(1)
    assert channel.stages(2) == list(channel.effects)
    apply, params = channel.sample(torch.Generator().manual_seed(0), 2, 1)
    assert "stereo_widener" not in apply and "stereo_widener" not in params
    apply2, _ = channel.sample(torch.Generator().manual_seed(0), 2, 2)
    assert bool(apply2["stereo_widener"].all())
    # only the widener on: mono passes through to the loudness stage alone
    x = torch.from_numpy(_audio(1, rows=2, T=4096))
    off = {n: torch.zeros(2, dtype=torch.bool) for n in channel.stages(1)}
    assert torch.equal(channel.render_batch(x, off, params), channel.normalize(x))


def test_unknown_probability_raises():
    with pytest.raises(ValueError, match="unknown effect prob flanger_prob"):
        RandomAudioEffectsChannel(SR, device="cpu", flanger_prob=0.5)
    with pytest.raises(ValueError, match="unknown effect prob"):
        JChannel(SR, flanger_prob=0.5)
    channel = RandomAudioEffectsChannel(SR, device="cpu", phaser_prob=1.0, reverb=0.0)
    assert channel.probs["phaser"] == 1.0 and channel.probs["reverb"] == 0.0


def test_channel_draws_decisions_at_its_probabilities():
    channel = RandomAudioEffectsChannel(SR, device="cpu", delay_prob=0.0,
                                        compressor_prob=1.0)
    apply, params = channel.sample(torch.Generator().manual_seed(0), 400, 2)
    assert not bool(apply["delay"].any()) and bool(apply["compressor"].all())
    assert abs(apply["parametric_eq"].float().mean().item() - 0.7) < 0.1
    assert all(v.shape[0] == 400 for p in params.values() for v in p.values())


def test_channel_call_is_seeded_and_normalised():
    channel = RandomAudioEffectsChannel(SR, device="cpu", **{
        f"{n}_prob": 1.0 for n in RandomAudioEffectsChannel.DEFAULT_PROBS})
    x = torch.from_numpy(_audio(2, rows=2, T=4096))
    y = channel(torch.Generator().manual_seed(5), x)
    again = channel(torch.Generator().manual_seed(5), x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert torch.equal(y, again)
    lufs = integrated_loudness(y, SR)
    assert torch.allclose(lufs, torch.full_like(lufs, -32.0), atol=0.1)
