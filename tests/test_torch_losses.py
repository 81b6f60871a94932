"""Losses of the port (``remfx_tpu_torch/losses``) and the wrapper's
``loss_and_output`` against the JAX package.

Tolerance: 1e-5 relative (fp32; the JAX package's STFT is a DFT matrix
product, the port's an FFT, so the sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.losses import (MultiResolutionSTFTLoss as JaxMRSTFT, l1_loss as jax_l1,
                              multi_resolution_stft_loss as jax_mrstft,
                              si_sdr as jax_si_sdr, sisdr_loss as jax_sisdr_loss)
from remfx_tpu.losses.stft_loss import stft_loss as jax_stft_loss
from remfx_tpu.models.dcunet import DCUNet as JaxDCUNet
from remfx_tpu.models.tcn import TCN as JaxTCN
from remfx_tpu.models.wrappers import ModelWrapper as JaxWrapper
from remfx_tpu.utils.crop import causal_crop as jax_causal_crop
from remfx_tpu_torch.compat.from_jax import dcunet_state_dict, tcn_state_dict
from remfx_tpu_torch.losses import (MultiResolutionSTFTLoss, STFTLoss, l1_loss,
                                    multi_resolution_stft_loss, removal_loss, si_sdr,
                                    sisdr_loss)
from remfx_tpu_torch.losses.stft_loss import (DEFAULT_FFT_SIZES, DEFAULT_HOP_SIZES,
                                              DEFAULT_WIN_LENGTHS)
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.wrappers import ModelWrapper

torch.set_num_threads(2)
RTOL = 1e-5
T = 8192


def _pair(seed=0, shape=(2, 1, T)):
    rng = np.random.default_rng(seed)
    y = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    x = (0.8 * y + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return x, y


def _close(got, want, rtol=RTOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("zero_mean", [True, False])
def test_sisdr_loss_matches_jax(zero_mean):
    x, y = _pair()
    want = jax_sisdr_loss(jnp.asarray(x), jnp.asarray(y), zero_mean=zero_mean)
    _close(sisdr_loss(torch.from_numpy(x), torch.from_numpy(y), zero_mean=zero_mean), want)


def test_si_sdr_matches_jax():
    x, y = _pair(1, (3, 4000))
    want = jax_si_sdr(jnp.asarray(x), jnp.asarray(y))
    got = si_sdr(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want)
    assert float(got) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_loss_matches_jax(dtype):
    x, y = _pair(2)
    want = jax_l1(jnp.asarray(x, dtype), jnp.asarray(y, dtype))
    tdt = getattr(torch, dtype)
    got = l1_loss(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("n_fft,hop,win", list(zip(
    DEFAULT_FFT_SIZES, DEFAULT_HOP_SIZES, DEFAULT_WIN_LENGTHS)))
def test_stft_loss_matches_jax_at_each_resolution(n_fft, hop, win):
    x, y = _pair(3)
    want = jax_stft_loss(jnp.asarray(x), jnp.asarray(y), n_fft, hop, win)
    _close(STFTLoss(n_fft, hop, win)(torch.from_numpy(x), torch.from_numpy(y)), want)


def test_multi_resolution_stft_loss_matches_jax():
    x, y = _pair(4)
    want = jax_mrstft(jnp.asarray(x), jnp.asarray(y))
    got = multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want)
    # the reference's kwargs are accepted and ignored, in both packages
    kw = dict(n_bins=1025, sample_rate=48000)
    _close(MultiResolutionSTFTLoss(**kw)(torch.from_numpy(x), torch.from_numpy(y)),
           JaxMRSTFT(**kw)(jnp.asarray(x), jnp.asarray(y)))
    same = multi_resolution_stft_loss(torch.from_numpy(y), torch.from_numpy(y))
    assert float(same) == 0.0


@pytest.mark.parametrize("short", [0, 1, 90])
def test_removal_loss_matches_the_jax_wrapper_formula(short):
    """MR-STFT + 100 x L1 against the target, causal-cropped (the JAX
    package's crop drops the final sample) when the output is shorter."""
    x, y = _pair(7)
    out = x[..., : T - short]
    yc = jnp.asarray(y) if short == 0 else jax_causal_crop(jnp.asarray(y), T - short)
    want = jax_mrstft(jnp.asarray(out), yc) + 100.0 * jax_l1(jnp.asarray(out), yc)
    _close(removal_loss(torch.from_numpy(out), torch.from_numpy(y)), want)


TCN_CFG = dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2)


def test_wrapper_loss_and_output_matches_jax_forward_with_a_shorter_output():
    """TCN: the output is 90 samples short, so the target is causal-cropped."""
    x, y = _pair(5)
    jw = JaxWrapper(JaxTCN(**TCN_CFG))
    v = jax.device_get(jw.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want_loss, want_out, _ = jw.forward(v, (jnp.asarray(x), jnp.asarray(y)))
    port = TCN(**TCN_CFG)
    port.load_state_dict(tcn_state_dict(v), strict=True)
    with torch.no_grad():
        loss, out = ModelWrapper(port.eval()).loss_and_output(
            (torch.from_numpy(x), torch.from_numpy(y)))
    assert out.shape == want_out.shape == (2, 1, T - 90)
    _close(loss, want_loss)


def test_wrapper_loss_and_output_matches_jax_forward_at_equal_length():
    x, y = _pair(6, (2, 1, 4000))
    cfg = dict(architecture="Mini-DCUNet-6", stft_kernel_size=64)
    jw = JaxWrapper(JaxDCUNet(**cfg), takes_train_flag=True)
    v = jax.device_get(jw.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want_loss, _, _ = jw.forward(v, (jnp.asarray(x), jnp.asarray(y)))
    port = DCUNet(**cfg)
    port.load_state_dict(dcunet_state_dict(v), strict=True)
    with torch.no_grad():
        loss, out = ModelWrapper(port.eval()).loss_and_output(
            (torch.from_numpy(x), torch.from_numpy(y)))
    assert out.shape == x.shape
    _close(loss, want_loss)
