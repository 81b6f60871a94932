"""The port's UMX (``remfx_tpu_torch/models/umx.py``) against the JAX
package's on the CPU, with the JAX weights carried across by
``compat.from_jax.umx_state_dict``.

* Small width (n_fft 512, hop 256, hidden 64) on 2 x 4096 from a numpy
  seed: ``sample`` in eval mode, through the Wiener post-filter, and the
  output of a train-mode call, with ``identity_init`` on and off, at
  1e-5 of the JAX output's peak (measured at most 9.3e-7). In train mode
  the LSTM's dropout is 0 on both sides (the JAX module fixes it at 0.4
  and draws its mask from a JAX key, which the port cannot reproduce),
  so both compute the same function.
* The BatchNorm running statistics after that train-mode call against
  JAX's ``batch_stats``, 1e-5 relative (measured at most 3.3e-7): both
  update the variance with the unbiased batch variance.
* The vendored ``ckpts/umx_reverb_synth`` at full width, read by the
  port's orbax reader (bf16 parameters upcast to fp32), against JAX's
  ``load_trained_wrapper(..., niter=1)`` on 2 x 16384 of demo audio: at
  1e-4 of the JAX output's peak (measured 8.5e-7).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import remfx_tpu.models.umx as jumx
from remfx_tpu.models import lstm as jlstm
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.train.checkpoint import load_trained_wrapper as jax_load_trained
from remfx_tpu_torch.compat.from_jax import umx_state_dict
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.models import make_model
from remfx_tpu_torch.train.checkpoint import load_trained_wrapper

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_fft=512, hop_length=256, hidden_size=64)
TOL = 1e-5


def _x(T=4096, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((2, 1, T))).astype(np.float32)


def _no_dropout_lstm(*args, **kwargs):
    kwargs["dropout"] = 0.0
    return jlstm.LSTM(*args, **kwargs)


@functools.cache
def _variables(identity_init):
    """JAX UMX variables, running statistics away from (0, 1) so that eval
    mode reads them; the parameters do not depend on niter or softmask."""
    jw = jax_make_model("umx", **SMALL, identity_init=identity_init)
    variables = jax.device_get(jw.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 4096))))
    rng = np.random.default_rng(2)
    variables["batch_stats"] = {"model": {
        bn: {"running_mean": rng.uniform(-0.2, 0.2, s["running_mean"].shape)
             .astype(np.float32),
             "running_var": rng.uniform(0.5, 1.5, s["running_var"].shape)
             .astype(np.float32)}
        for bn, s in variables["batch_stats"]["model"].items()}}
    return variables


def _pair(identity_init, **net):
    jw = jax_make_model("umx", **SMALL, identity_init=identity_init, **net)
    variables = _variables(identity_init)
    port = make_model("umx", **SMALL, identity_init=identity_init, device="cpu", **net)
    port.module.load_state_dict(umx_state_dict(variables), strict=True)
    return jw, variables, port, _x()


@pytest.mark.parametrize("identity_init", [False, True])
def test_umx_init_constants_match_jax(identity_init):
    """input_mean, input_scale, output_scale and output_mean start where
    the JAX module starts them."""
    jw = jax_make_model("umx", **SMALL, identity_init=identity_init)
    params = jw.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 2048)))["params"]["model"]
    port = make_model("umx", **SMALL, identity_init=identity_init, device="cpu").module.model
    for name in ("input_mean", "input_scale", "output_scale", "output_mean"):
        np.testing.assert_array_equal(getattr(port, name).detach().numpy(),
                                      np.asarray(params[name]), err_msg=name)


@pytest.mark.parametrize("identity_init", [False, True])
def test_umx_sample_matches_jax(identity_init):
    jw, variables, port, x = _pair(identity_init)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("identity_init", [False, True])
def test_umx_train_mode_and_batch_stats_match_jax(identity_init, monkeypatch):
    monkeypatch.setattr(jumx, "LSTM", _no_dropout_lstm)
    jw, variables, port, x = _pair(identity_init)
    want, updates = jax.jit(lambda v, x: jw.apply(
        v, x, train=True, rngs={"dropout": jax.random.PRNGKey(3)}))(variables, jnp.asarray(x))
    port.module.model.lstm.dropout = 0.0
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    stats = jax.device_get(updates["batch_stats"])["model"]
    for bn in ("bn1", "bn2", "bn3"):
        mod = getattr(port.module.model, bn)
        for stat in ("running_mean", "running_var"):
            w = np.asarray(stats[bn][stat])
            np.testing.assert_allclose(getattr(mod, stat).numpy(), w, rtol=TOL,
                                       atol=TOL * np.abs(w).max(), err_msg=f"{bn}.{stat}")


@pytest.mark.parametrize("net", [dict(niter=1), dict(niter=2), dict(softmask=True),
                                 dict(niter=1, softmask=True, wiener_win_len=5)],
                         ids=["niter1", "niter2", "softmask", "niter1_softmask_win5"])
def test_umx_wiener_separator_matches_jax(net):
    """The separator through the Wiener post-filter, per example."""
    jw, variables, port, x = _pair(True, **net)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_trained_umx_matches_jax():
    d = ROOT / "ckpts" / "umx_reverb_synth"
    effect, jw, variables = jax_load_trained(str(d), niter=1)
    effect_port, port = load_trained_wrapper(d, device="cpu", niter=1)
    assert effect == effect_port == "reverb"
    assert port.module.niter == 1
    assert all(p.dtype == torch.float32 for p in port.parameters())
    a, sr = read_wav(ROOT / "demos" / "synth_distortion_reverb.wav")
    b, _ = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    assert sr == 48000
    x = np.stack([a[:, :16384], b[:, :16384]]).astype(np.float32)
    want = np.asarray(jax.jit(jw.sample)(variables, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------------------------ training

LR = 1e-4


def _batch(T=4096, seed=5):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((2, 1, T)) * np.linspace(0.2, 1.0, T)
    return x.astype(np.float32), (0.5 * np.tanh(2 * x)).astype(np.float32)


def test_umx_train_step_matches_jax(monkeypatch):
    """One fp32 RemovalTask step from the same weights and batch, dropout 0
    on both sides: the loss at 1e-5 relative and the metrics at 1e-4 x
    max(|value|, 1), as tests/test_torch_train.py holds the other
    backbones; the running statistics at 1e-5 of their largest value.
    The parameters in units of lr, which Adam moves each by about,
    whatever its gradient's size: within 0.5 lr, with at most 0.1% of the
    118,150 elements beyond 0.05 lr (measured 0.14 lr, at elements of fc1
    and fc3 whose gradients are near zero, and 7 elements beyond 0.05 lr;
    every LSTM and BatchNorm parameter within 0.017 lr)."""
    from remfx_tpu.train import tasks as jtasks
    from remfx_tpu_torch.train import tasks as ttasks

    monkeypatch.setattr(jumx, "LSTM", _no_dropout_lstm)
    x, y = _batch()
    jw = jax_make_model("umx", **SMALL, identity_init=True)
    jtask = jtasks.RemovalTask(jw, max_steps=100)
    jstate = jtask.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    port = make_model("umx", **SMALL, identity_init=True, device="cpu")
    jvars = {"params": jax.device_get(jstate.params),
             "batch_stats": jax.device_get(jstate.batch_stats)}
    port.module.load_state_dict(umx_state_dict(jvars), strict=True)
    port.module.model.lstm.dropout = 0.0
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
    jsd = umx_state_dict({"params": jax.device_get(jstate.params),
                          "batch_stats": jax.device_get(jstate.batch_stats)})
    sd = port.module.state_dict()
    errs = []
    for k, w in jsd.items():
        g, w = sd[k].numpy(), w.numpy()
        if "running" in k:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
        elif "num_batches" in k:
            assert int(g) == 1, k
        else:
            errs.append(np.abs(g - w).ravel())
    errs = np.concatenate(errs)
    assert errs.max() <= 0.5 * LR, errs.max() / LR
    assert np.mean(errs > 0.05 * LR) <= 1e-3


def test_default_experiment_fits_on_the_cpu(tmp_path):
    """``+exp=default`` (UMX, monolithic 0-5 removed effects in the
    reference's order, no shuffle) through fit and test on the dynamic
    synthetic dataset, at a tiny width: finite metrics, and UMX's
    BatchNorms in train mode during fit."""
    from remfx_tpu_torch.config.core import parse_cli
    from remfx_tpu_torch.models import UMXSeparator
    from remfx_tpu_torch.train.loop import fit

    cfg = parse_cli([
        "+exp=default", "accelerator=cpu", "datamodule.synthetic=true",
        "datamodule.dataset_type=dynamic", "model.network.n_fft=256",
        "model.network.hop_length=128", "model.network.hidden_size=16",
        "chunk_size=4096", "datamodule.train_chunks=4", "datamodule.val_chunks=2",
        "datamodule.test_chunks=2", "datamodule.train_batch_size=2",
        "datamodule.test_batch_size=2", "trainer.max_steps=2", "log_audio=false",
        f"logs_dir={tmp_path}", f"render_root={tmp_path / 'data'}"])
    assert cfg["model"]["name"] == "umx" and cfg["num_removed_effects"] == [0, 5]
    assert not cfg["shuffle_removed_effects"]
    state, metrics = fit(cfg)
    assert isinstance(state.model.module, UMXSeparator) and state.step == 2
    assert int(state.model.module.model.bn1.num_batches_tracked) == 2
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
