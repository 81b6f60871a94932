"""HDemucs (and its LSTM) of the port against the JAX package.

Config as ``tests/test_demucs_parity.py:30-39`` (channels 8, nfft 64,
depth 3, norm_starts 1, dconv_lstm 2, dconv_attn 1): freq layers, the
collapsing last freq layer with the time-branch inject, the time-only
bottleneck, GroupNorms, DConv with BLSTM and LocalState, the empty time
decoder and the frequency embedding. At 8000 samples the bottleneck has
250 steps, so the BLSTM runs its 200-step framing.

Tolerance: 1e-4 x the RMS of the JAX output (fp32, another summation
order through ~20 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models.demucs import HDemucs as JaxHDemucs
from remfx_tpu.models.lstm import LSTM as JaxLSTM
from remfx_tpu.models.wrappers import ModelWrapper as JaxWrapper
from remfx_tpu_torch.compat.from_jax import demucs_state_dict
from remfx_tpu_torch.models import make_demucs
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.lstm import LSTM
from remfx_tpu_torch.models.wrappers import ModelWrapper

torch.set_num_threads(2)
CFG = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64,
           depth=3, norm_starts=1, dconv_lstm=2, dconv_attn=1)
T = 8000
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = JaxHDemucs(**CFG)
    variables = JaxWrapper(jm, takes_train_flag=True).init(
        jax.random.PRNGKey(1), jnp.zeros((2, 1, T)))
    variables = jax.device_get(variables)
    port = HDemucs(**CFG)
    port.load_state_dict(demucs_state_dict(variables), strict=True)
    return jm, variables, port.eval()


def _audio(seed=0, T=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1, T)).astype(np.float32)
    x *= np.linspace(0.2, 1.0, T, dtype=np.float32)
    return (0.3 * x).astype(np.float32)


@pytest.mark.parametrize("residual", [False, True])
def test_wrapper_sample_matches_jax(pair, residual):
    jm, variables, port = pair
    x = _audio()
    jw = JaxWrapper(jm, takes_train_flag=True, residual=residual)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = ModelWrapper(port, residual=residual).sample(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, T)
    rms = np.sqrt(np.mean(want**2))
    assert np.abs(got - want).max() <= TOL * rms


@pytest.mark.parametrize("T_short", [20, 1000])
def test_spec_and_ispec_match_jax(pair, T_short):
    """20 samples is shorter than the 24-sample reflect pad: demucs'
    short-signal pad rule."""
    jm, _, port = pair
    x = _audio(seed=3, T=T_short)
    jre, jim = jm.apply({}, jnp.asarray(x), method=JaxHDemucs._spec)
    tre, tim = port._spec(torch.from_numpy(x))
    scale = np.abs(np.asarray(jre)).max()
    assert tre.shape == jre.shape
    assert np.abs(tre.numpy() - np.asarray(jre)).max() <= 1e-5 * scale
    assert np.abs(tim.numpy() - np.asarray(jim)).max() <= 1e-5 * scale
    want = np.asarray(jm.apply({}, jre, jim, T_short, method=JaxHDemucs._ispec))
    got = port._ispec(tre, tim, T_short).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lstm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((30, 3, 6)).astype(np.float32)  # (T, B, F)
    jl = JaxLSTM(5, num_layers=2, bidirectional=True)
    v = jax.device_get(jl.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    port = LSTM(6, 5, num_layers=2, bidirectional=True)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in v["params"].items()},
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (30, 3, 10)
    assert np.abs(got - want).max() <= 1e-5


def test_identity_init_zeroes_the_final_convs_and_adds_the_input():
    w = make_demucs(channels=8, nfft=64, depth=3, identity_init=True, device="cpu")
    assert w.residual
    for layer in (w.module.freq_decoder[-1], w.module.time_decoder[-1]):
        assert not layer.conv_tr.weight.any() and not layer.conv_tr.bias.any()
    x = torch.from_numpy(_audio(seed=5, T=2000))
    y = w.sample(x)
    with torch.no_grad():
        contribution = w.module(x)
    torch.testing.assert_close(y, x + contribution, rtol=0, atol=0)
    # what is left is the de-normalisation's mean terms, small beside x
    assert contribution.abs().max() < 0.1 * x.abs().max()
