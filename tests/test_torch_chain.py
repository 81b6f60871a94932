"""Detect -> remove chain of the port against the JAX package, with the
small HDemucs of ``test_torch_demucs.py`` in the compressor slot and a
full-width Cnn14 as classifier, weights carried from JAX inits.

Tolerance: 1e-4 x the RMS of the JAX output for audio; labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.fx.compressor import render_batch as jax_render_batch
from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models.demucs import HDemucs as JaxHDemucs
from remfx_tpu.models.wrappers import ModelWrapper as JaxWrapper
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.compat.from_jax import cnn14_state_dict, demucs_state_dict
from remfx_tpu_torch.fx.compressor import render_batch
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.wrappers import ModelWrapper

torch.set_num_threads(2)
CFG = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64,
           depth=3, norm_starts=1, dconv_lstm=2, dconv_attn=1)
SR = 48000
B, T = 2, 8192
TOL = 1e-4
SLOT = "RandomPedalboardCompressor"
COMP = ALL_EFFECTS.index("compressor")


@pytest.fixture(scope="module")
def chains():
    net = jax_make_cnn14()
    cv = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((B, T))))
    jw = JaxWrapper(JaxHDemucs(**CFG), takes_train_flag=True, residual=True)
    dv = jax.device_get(jw.init(jax.random.PRNGKey(1), jnp.zeros((B, 1, T))))
    cls = make_cnn14(device="cpu")
    cls.load_state_dict(cnn14_state_dict(cv), strict=True)
    dm = HDemucs(**CFG)
    dm.load_state_dict(demucs_state_dict(dv), strict=True)
    tw = ModelWrapper(dm, residual=True)

    def both(**kw):
        jax_chain = JaxChain({SLOT: (jw, dv)}, SR, classifier=(net, cv),
                             dispatch="staged", **kw)
        port_chain = ChainInference({SLOT: tw}, SR, classifier=cls, **kw)
        return jax_chain, port_chain

    return both


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, T)).astype(np.float32)
    x *= np.linspace(0.2, 1.0, T, dtype=np.float32)
    return (0.3 * x).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.sqrt(np.mean(want**2))


def test_detect_matches_jax(chains):
    jc, pc = chains()
    x = _audio()
    want = np.asarray(jc.detect(jnp.asarray(x)))
    got = pc.detect(torch.from_numpy(x)).numpy()
    assert got.shape == (B, len(ALL_EFFECTS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask", [(1.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
def test_oracle_remove_matches_jax(chains, mask):
    jc, pc = chains()
    x = _audio(seed=1)
    labels = np.zeros((B, len(ALL_EFFECTS)), np.float32)
    labels[:, COMP] = mask
    want, _ = jc.remove(jnp.asarray(x), jnp.asarray(labels))
    got, _ = pc.remove(torch.from_numpy(x), torch.from_numpy(labels))
    _close(got.numpy(), np.asarray(want))
    for i, m in enumerate(mask):  # unselected examples pass through untouched
        if not m:
            np.testing.assert_array_equal(got[i].numpy(), x[i])


def test_use_all_effect_models_matches_jax(chains):
    jc, pc = chains(use_all_effect_models=True)
    x = _audio(seed=2)
    xj = jnp.asarray(x)
    want = np.asarray(jc.sample((xj, xj, None, jnp.zeros((B, len(ALL_EFFECTS))))))
    got, labels = pc.run(torch.from_numpy(x))
    assert torch.equal(labels, torch.ones(B, len(ALL_EFFECTS)))
    _close(got.numpy(), want)


def test_all_equals_oracle_with_the_compressor_label(chains):
    """Dispatch consistency (BASELINE.md:236): with only the compressor
    slot loaded, "all" and oracle-with-compressor-label are bit-equal."""
    _, pc_all = chains(use_all_effect_models=True)
    _, pc = chains()
    x = torch.from_numpy(_audio(seed=3))
    labels = torch.zeros(B, len(ALL_EFFECTS))
    labels[:, COMP] = 1.0
    y_all, _ = pc_all.run(x)
    y_oracle, _ = pc.remove(x, labels)
    assert torch.equal(y_all, y_oracle)


def test_render_detect_remove_slice_matches_jax(chains):
    """The slice end to end on the CPU: compressor render -> Cnn14 detect
    -> HDemucs removal, port against JAX."""
    jc, pc = chains()
    x = _audio(seed=4)
    params = {
        "threshold_db": np.array([-35.0, -22.0], np.float32),
        "ratio": np.array([5.0, 2.0], np.float32),
        "attack_ms": np.array([2.0, 30.0], np.float32),
        "release_ms": np.array([50.0, 200.0], np.float32),
    }
    wet_j = jax_render_batch(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, SR)
    wet_t = render_batch(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}, SR)
    _close(wet_t.numpy(), np.asarray(wet_j))
    labels_j = jc.detect(wet_j)
    labels_t = pc.detect(wet_t)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    # the seeded classifier may detect nothing: switch the compressor on
    # for one example so the removal stage runs in both packages
    labels_j = labels_j.at[0, COMP].set(1.0)
    labels_t[0, COMP] = 1.0
    want, _ = jc.remove(wet_j, labels_j)
    got, _ = pc.remove(wet_t, labels_t)
    _close(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()
