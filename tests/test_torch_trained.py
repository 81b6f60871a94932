"""The vendored trained checkpoints carried into the port on the CPU.

``remfx_tpu.train.checkpoint`` (JAX, orbax) reads ``ckpts/``; the
variables go through ``compat.from_jax`` into the port, and both
packages run the same demo audio.

The five removal slots of the main path (TCN distortion, HDemucs
compressor, Large-DCUNet-20 reverb / chorus / delay) and the classifier
also run as one chain, detect and oracle, at 16384 samples, and in the
``slow`` test at the full 262144 (ROADMAP §A1's full-width check; minutes
on the CPU, so outside Tier-1). Tolerance for audio: 1e-4 x the RMS of
the JAX output; labels equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.train.checkpoint import load_trained_classifier, load_trained_wrapper
from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.compat.from_jax import (cnn14_state_dict, dcunet_state_dict,
                                             demucs_state_dict, tcn_state_dict)
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.models import make_cnn14, make_demucs, make_model

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _demo(T):
    x, sr = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    assert sr == 48000
    y, _ = read_wav(ROOT / "demos" / "synth_distortion_reverb.wav")
    return np.stack([x[:, :T], y[:, :T]]).astype(np.float32)  # (2, 1, T)


def test_trained_classifier_carries_over():
    """ckpts/classifier_cnn14_r5 through from_jax: the same probabilities
    (1e-4, as in test_torch_cnn14.py) and labels as JAX on demo audio."""
    net, variables = load_trained_classifier(ROOT / "ckpts" / "classifier_cnn14_r5")
    x = _demo(32768)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    port = make_cnn14(device="cpu")
    port.load_state_dict(cnn14_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


def test_trained_demucs_carries_over():
    """ckpts/demucs_compressor_aug_r5 (identity_init, so a residual
    wrapper) at full width through from_jax: the same removal as JAX to
    1e-4 x the output RMS, as in test_torch_demucs.py."""
    effect, jw, variables = load_trained_wrapper(ROOT / "ckpts" / "demucs_compressor_aug_r5")
    assert effect == "compressor" and jw.residual
    x = _demo(16384)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    port = make_demucs(identity_init=True, device="cpu")
    port.module.load_state_dict(demucs_state_dict(variables), strict=True)
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))


SLOT_CKPTS = {
    "distortion": "tcn_distortion_aug",
    "compressor": "demucs_compressor_aug_r5",
    "reverb": "dcunet_reverb_aug_r4",
    "chorus": "dcunet_chorus_aug_r5",
    "delay": "dcunet_delay_aug_r5",
}
BRIDGES = {"tcn": tcn_state_dict, "dcunet": dcunet_state_dict,
           "demucs": demucs_state_dict}
_LOADED: dict = {}


def _trained(name):
    """(effect, JAX wrapper, variables, port wrapper) for ``ckpts/<name>``,
    the port built by ``make_model`` from the same hparams.json."""
    if name not in _LOADED:
        d = ROOT / "ckpts" / name
        effect, jw, variables = load_trained_wrapper(d)
        hp = json.loads((d / "hparams.json").read_text())
        port = make_model(hp["model"]["name"], sample_rate=hp["sample_rate"],
                          device="cpu", **hp["model"]["network"])
        port.module.load_state_dict(BRIDGES[hp["model"]["name"]](variables),
                                    strict=True)
        _LOADED[name] = (effect, jw, variables, port)
    return _LOADED[name]


def _rms_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))


@pytest.mark.parametrize("name", ["tcn_distortion_aug", "dcunet_reverb_aug_r4",
                                  "dcunet_chorus_aug_r5", "dcunet_delay_aug_r5"])
def test_trained_removal_slot_carries_over(name):
    """The TCN and the three DCUNets through from_jax, on demo audio at
    16384 samples: the same removal as JAX to 1e-4 x the output RMS."""
    effect, jw, variables, port = _trained(name)
    assert SLOT_CKPTS[effect] == name
    x = _demo(16384)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape[-1] == port.output_length(16384)
    _rms_close(got, want)


def _trained_chains():
    net, cv = load_trained_classifier(ROOT / "ckpts" / "classifier_cnn14_r5")
    cls = make_cnn14(device="cpu")
    cls.load_state_dict(cnn14_state_dict(cv), strict=True)
    jaxs, ports = {}, {}
    for effect, name in SLOT_CKPTS.items():
        _, jw, variables, port = _trained(name)
        slot = next(k for k, v in EFFECT_CLASS_NAMES.items() if v == effect)
        jaxs[slot], ports[slot] = (jw, variables), port
    jc = JaxChain(jaxs, 48000, classifier=(net, cv), dispatch="staged")
    pc = ChainInference(ports, 48000, classifier=cls)
    return jc, pc


def _check_trained_chain(T):
    jc, pc = _trained_chains()
    x = _demo(T)
    labels_j = jc.detect(jnp.asarray(x))
    labels_t = pc.detect(torch.from_numpy(x))
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    rf = pc.models[DEFAULT_ORDER[0]].module.compute_receptive_field()
    for labels in (np.array(labels_j),  # detect
                   np.array([[1, 1, 1, 1, 1], [1, 0, 1, 0, 1]], np.float32)):
        want, _ = jc.remove(jnp.asarray(x), jnp.asarray(labels))
        got, _ = pc.remove(torch.from_numpy(x), torch.from_numpy(labels))
        assert got.shape == (2, 1, T - rf + 1)
        _rms_close(got.numpy(), np.asarray(want))


def test_trained_five_slot_chain_matches_jax():
    """The trained classifier and five slots as one chain at 16384
    samples: detect's labels, then removal with those labels and with
    oracle labels."""
    _check_trained_chain(16384)
    assert len(ALL_EFFECTS) == len(SLOT_CKPTS)


@pytest.mark.slow
def test_trained_five_slot_chain_matches_jax_at_full_width():
    """As above at 262144 samples (256006 out), the main path's width."""
    _check_trained_chain(262144)
