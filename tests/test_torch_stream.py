"""The port's streaming inference (``chain/stream.py``) against the JAX
package's.

The trained TCN (distortion; it shortens its output by 6138 samples, so
every window is tail-aligned) and the trained Large-DCUNet-20 reverb
remover, over 40000 samples of a demo clip in windows of 16384 samples
that overlap by 2048 (three windows): the port's ``stream_chain`` gives
JAX's labels and its output to 1e-4 x the RMS of the JAX output, with
the classifier's detection on the loudest window, with labels given, and
with every effect on. The window offsets equal JAX's; one window equals
the chain's ``remove`` bit for bit.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.build import build_chain as jax_build_chain
from remfx_tpu.chain.stream import _windows as jax_windows
from remfx_tpu.chain.stream import stream_chain as jax_stream_chain
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.chain.stream import _windows, stream_chain
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.data.wav import read_wav

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CHUNK, OVERLAP, T = 16384, 2048, 40000
SLOTS = {"RandomPedalboardDistortion": "tcn_distortion_aug",
         "RandomPedalboardReverb": "dcunet_reverb_aug_r4"}
_CHAINS: dict = {}


def _cfg(classifier: bool):
    cfg = parse_cli(["+exp=remfx_detect" if classifier else "+exp=remfx_oracle"])
    cfg["ckpts"] = {k: {"model": "tcn", "ckpt_path": str(ROOT / "ckpts" / v)}
                    for k, v in SLOTS.items()}
    if classifier:
        cfg["classifier_ckpt"] = str(ROOT / "ckpts" / "classifier_cnn14_r5")
    return cfg


def _chains(classifier: bool):
    """(JAX chain, port chain), built once per module."""
    if classifier not in _CHAINS:
        cfg = _cfg(classifier)
        _CHAINS[classifier] = (
            jax_build_chain(copy.deepcopy(cfg), jnp.zeros((1, 1, CHUNK))),
            build_chain(copy.deepcopy(cfg), None, device="cpu"))
    return _CHAINS[classifier]


def _audio(n=T):
    x, _ = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    return np.ascontiguousarray(x[:, :n], np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))


@pytest.mark.parametrize("T_,chunk,hop", [(100, 100, 50), (99, 100, 50),
                                          (1000, 300, 250), (40000, 16384, 14336),
                                          (16385, 16384, 1)])
def test_windows_equal_jax(T_, chunk, hop):
    assert _windows(T_, chunk, hop) == jax_windows(T_, chunk, hop)


@pytest.mark.parametrize("case", ["detect", "labels", "no_classifier"])
def test_stream_matches_jax(case):
    classifier = case == "detect"
    jc, pc = _chains(classifier)
    labels = np.array([1, 0, 0, 1, 0], np.float32) if case == "labels" else None
    x = _audio()
    yj, lj = jax_stream_chain(jc, x, chunk=CHUNK, overlap=OVERLAP, labels=labels)
    yt, lt = stream_chain(pc, torch.from_numpy(x), chunk=CHUNK, overlap=OVERLAP,
                          labels=labels)
    assert len(_windows(T, CHUNK, CHUNK - OVERLAP)) == 3
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert yt.shape == (1, T)
    _close(yt.numpy(), yj)


def test_overlap_must_be_below_the_chunk():
    _, pc = _chains(False)
    x = torch.from_numpy(_audio(3000))
    for overlap in (1000, 1200, -1):
        with pytest.raises(ValueError, match="overlap"):
            stream_chain(pc, x, chunk=1000, overlap=overlap)


def test_use_all_effect_models_overrides_labels():
    jc, pc = _chains(False)
    x = _audio()
    zeros = np.zeros(5, np.float32)
    pc.use_all_effect_models = jc.use_all_effect_models = True
    try:
        yt, lt = stream_chain(pc, torch.from_numpy(x), chunk=CHUNK,
                              overlap=OVERLAP, labels=zeros)
        yj, _ = jax_stream_chain(jc, x, chunk=CHUNK, overlap=OVERLAP, labels=zeros)
    finally:
        pc.use_all_effect_models = jc.use_all_effect_models = False
    assert torch.equal(lt, torch.ones(5))
    ones, _ = stream_chain(pc, torch.from_numpy(x), chunk=CHUNK, overlap=OVERLAP)
    assert torch.equal(yt, ones)
    _close(yt.numpy(), yj)


def test_one_window_equals_remove_bit_for_bit():
    _, pc = _chains(False)
    x = torch.from_numpy(_audio(CHUNK))
    labels = torch.tensor([1.0, 0, 0, 1, 0])
    y, _ = stream_chain(pc, x, chunk=CHUNK, overlap=OVERLAP, labels=labels)
    want, _ = pc.remove(x[None], labels[None])
    assert torch.equal(y, want[0])


def test_short_input_is_padded_and_tail_aligned():
    """T < chunk: one zero-padded window; with the TCN the output is
    T - 6138 samples, equal to JAX's."""
    jc, pc = _chains(False)
    x = _audio(9000)
    labels = np.array([0, 0, 0, 1, 0], np.float32)
    yj, _ = jax_stream_chain(jc, x, chunk=CHUNK, overlap=OVERLAP, labels=labels)
    yt, _ = stream_chain(pc, torch.from_numpy(x), chunk=CHUNK, overlap=OVERLAP,
                         labels=labels)
    assert yt.shape == (1, 9000 - 6138)
    _close(yt.numpy(), yj)
    with pytest.raises(ValueError, match="receptive"):
        stream_chain(pc, torch.from_numpy(_audio(6000)), chunk=CHUNK,
                     overlap=OVERLAP, labels=labels)
