"""The port's DPTNet (``remfx_tpu_torch/models/dptnet.py``) against the
JAX package's on the CPU, with the JAX weights carried across by
``compat.from_jax.dptnet_state_dict``; inputs from a numpy seed.

* ``_unfold`` / ``_fold``: equal to JAX's exactly (pure indexing, and two
  overlapping chunks a frame, whose sum is the same in either order).
* ``GlobLN`` and ``ImprovedTransformerLayer`` (torch's
  ``nn.MultiheadAttention``, which the JAX ``TorchMHA`` reproduces): 1e-5
  of the JAX output's peak.
* The whole model's ``sample`` at ``chunk_size=20, n_repeats=1`` on 2 x
  4096 and on an input shorter than the kernel: 1e-5 of the JAX output's
  peak (measured at most 6.9e-7).
* The bridge uses every JAX leaf; a leaf left over raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import dptnet as jdpt
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu_torch.compat.from_jax import dptnet_state_dict
from remfx_tpu_torch.models import dptnet as tdpt
from remfx_tpu_torch.models import make_model

torch.set_num_threads(2)
TOL = 1e-5


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("chunk,T", [(20, 97), (100, 1000), (4, 3)])
def test_unfold_fold_equal_jax(chunk, T):
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 3, T)).astype(np.float32)
    hop = chunk // 2
    want = np.asarray(jdpt._unfold(jnp.asarray(x), chunk, hop))
    got = tdpt._unfold(torch.from_numpy(x), chunk, hop)
    np.testing.assert_array_equal(got.numpy(), want)
    seg = rng.standard_normal(want.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tdpt._fold(torch.from_numpy(seg), T, hop).numpy(),
        np.asarray(jdpt._fold(jnp.asarray(seg), T, hop)))
    # fold of unfold gives the frames back (two chunks cover every frame)
    np.testing.assert_allclose(tdpt._fold(got, T, hop).numpy(), x, rtol=1e-6)


def test_globln_matches_jax():
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 8, 50)) + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    want = np.asarray(jdpt.GlobLN().apply(
        {"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x)))
    ln = tdpt.GlobLN(8)
    ln.load_state_dict({"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)})
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_transformer_layer_matches_jax(bidirectional):
    rng = np.random.default_rng(2)
    S, B, C = 11, 3, 16
    x = rng.standard_normal((S, B, C)).astype(np.float32)
    layer = jdpt.ImprovedTransformerLayer(C, dim_ff=24, n_heads=4,
                                          bidirectional=bidirectional)
    params = jax.jit(layer.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                          .astype(np.float32), jax.device_get(params))
    want = np.asarray(jax.jit(layer.apply)({"params": params}, jnp.asarray(x)))
    sd = dptnet_state_dict({"params": {"layers_0_inter": params}})
    prefix = "masker.layers.0.1."
    port = tdpt.ImprovedTransformerLayer(C, 4, 24, bidirectional)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), want)


@pytest.fixture(scope="module")
def seeded():
    """A JAX DPTNet (chunk_size 20, one repeat), its variables, and the port
    model with the same weights; the parameters do not depend on T."""
    net = dict(chunk_size=20, n_repeats=1)
    jw = jax_make_model("dptnet", **net)
    variables = jax.device_get(jw.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 256))))
    port = make_model("dptnet", device="cpu", **net)
    port.module.load_state_dict(dptnet_state_dict(variables), strict=True)
    return jw, variables, port


@pytest.mark.parametrize("T", [4096, 10], ids=["4096", "shorter_than_kernel"])
def test_dptnet_sample_matches_jax(seeded, T):
    jw, variables, port = seeded
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 1, T))).astype(np.float32)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and np.abs(want).max() > 0
    _close(got, want)
    assert port.output_length(T) == T


def test_dptnet_two_sources_keep_the_first():
    """n_src=2: the head computes both masks and the wrapper's output is
    source 0's, as in the JAX package."""
    net = dict(chunk_size=20, n_repeats=1, n_src=2)
    jw = jax_make_model("dptnet", **net)
    variables = jax.device_get(jw.init(jax.random.PRNGKey(4), jnp.zeros((1, 1, 256))))
    port = make_model("dptnet", device="cpu", **net)
    port.module.load_state_dict(dptnet_state_dict(variables), strict=True)
    x = (0.3 * np.random.default_rng(6).standard_normal((2, 1, 1024))).astype(np.float32)
    _close(port.sample(torch.from_numpy(x)).numpy(),
           np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x))))


def test_dptnet_bridge_uses_every_leaf(seeded):
    jw, variables, port = seeded
    sd = dptnet_state_dict(variables)
    assert set(sd) == set(port.module.state_dict())
    extra = {"params": {**variables["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        dptnet_state_dict(extra)


def test_dptnet_train_step_matches_jax():
    """One fp32 RemovalTask step from the same weights and batch: the loss
    at 1e-5 relative and the metrics at 1e-4 x max(|value|, 1), as
    tests/test_torch_train.py holds the other backbones (measured 9.5e-8);
    the parameters within 0.1 lr, as for the TCN and HDemucs there (Adam
    moves each by about lr; measured 0.0028 lr)."""
    from remfx_tpu.train import tasks as jtasks
    from remfx_tpu_torch.train import tasks as ttasks

    rng = np.random.default_rng(5)
    T, lr = 4096, 1e-4
    x = (0.3 * rng.standard_normal((2, 1, T)) * np.linspace(0.2, 1.0, T)).astype(np.float32)
    y = (0.5 * np.tanh(2 * x)).astype(np.float32)
    jw = jax_make_model("dptnet", chunk_size=20, n_repeats=1)
    jtask = jtasks.RemovalTask(jw, max_steps=100)
    jstate = jtask.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    port = make_model("dptnet", chunk_size=20, n_repeats=1, device="cpu")
    port.module.load_state_dict(
        dptnet_state_dict({"params": jax.device_get(jstate.params)}), strict=True)
    task = ttasks.RemovalTask(port, max_steps=100)
    state = task.init_state()
    jstate, jm = jtask.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)),
                                  jax.random.PRNGKey(1))
    state, m = task.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    want = {k: float(v) for k, v in jm.items()}
    got = {k: float(v) for k, v in m.items()}
    assert set(got) == set(want)
    assert abs(got["train_loss"] - want["train_loss"]) <= 1e-5 * abs(want["train_loss"])
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), k
    jsd = dptnet_state_dict({"params": jax.device_get(jstate.params)})
    sd = port.module.state_dict()
    err = max(np.abs(sd[k].numpy() - w.numpy()).max() for k, w in jsd.items())
    assert err <= 0.1 * lr, err / lr
