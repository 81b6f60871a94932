"""``compat.from_jax``: every JAX leaf is carried over, every parameter
and buffer of the port is set (``strict=True``), in the right layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models.demucs import HDemucs as JaxHDemucs
from remfx_tpu_torch.compat.from_jax import cnn14_state_dict, demucs_state_dict
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.demucs import HDemucs

torch.set_num_threads(2)
CFG = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64,
           depth=3, norm_starts=1, dconv_lstm=2, dconv_attn=1)


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def cnn14_vars():
    net = jax_make_cnn14()
    return jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4096))))


@pytest.fixture(scope="module")
def demucs_vars():
    return jax.device_get(jax.jit(JaxHDemucs(**CFG).init)(jax.random.PRNGKey(1), jnp.zeros((1, 1, 800))))


def _load(model, sd):
    res = model.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert set(sd) == set(model.state_dict())


def test_cnn14_every_leaf_and_parameter(cnn14_vars):
    sd = cnn14_state_dict(cnn14_vars)
    model = make_cnn14(device="cpu")
    _load(model, sd)
    # JAX leaves <-> port tensors, less the 12 num_batches_tracked buffers
    assert _n_leaves(cnn14_vars) == len(sd) - 12
    k = np.asarray(cnn14_vars["params"]["conv_block2"]["conv1"]["kernel"])
    np.testing.assert_array_equal(model.conv_block2.conv1.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.heads[3].weight.detach().numpy(),
                                  np.asarray(cnn14_vars["params"]["head3"]["kernel"]).T)
    np.testing.assert_array_equal(
        model.conv_block6.bn2.running_var.numpy(),
        np.asarray(cnn14_vars["batch_stats"]["conv_block6"]["bn2"]["var"]))


def test_demucs_every_leaf_and_parameter(demucs_vars):
    sd = demucs_state_dict(demucs_vars)
    model = HDemucs(**CFG)
    _load(model, sd)
    assert _n_leaves(demucs_vars) == len(sd)
    p = demucs_vars["params"]
    np.testing.assert_array_equal(
        model.freq_emb.embedding.weight.detach().numpy(),
        np.asarray(p["freq_emb"]["weight"]))
    np.testing.assert_array_equal(
        model.freq_decoder[0].conv_tr.weight.detach().numpy(),
        np.asarray(p["freq_decoder_0"]["conv_tr_kernel"]).transpose(1, 2, 0))


@pytest.mark.parametrize("which", ["cnn14", "demucs"])
def test_a_leaf_left_over_raises(cnn14_vars, demucs_vars, which):
    variables, fn = ((cnn14_vars, cnn14_state_dict) if which == "cnn14"
                     else (demucs_vars, demucs_state_dict))
    extra = {**variables, "params": {**variables["params"],
                                    "stray": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="stray"):
        fn(extra)
