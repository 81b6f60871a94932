"""The port's training path (``remfx_tpu_torch/train``) against the JAX
package's: train steps, the optimizer, the classifier's losses and
metrics, the config, and the fit/test loop.

Train steps: the same weights (carried by ``compat/from_jax.py``) and the
same batch, three ``RemovalTask.train_step`` calls on each side, for a
small HDemucs, a small TCN and a Mini-DCUNet-6 with ``bN``. Tolerances,
from measurements on this test's data:

  * the loss at each step: 1e-5 relative (measured at most 1.8e-6, the
    DCUNet's third step; 1.1e-7 for the first step of each model);
  * the metrics: 1e-4 x max(|value|, 1) (measured at most 5.3e-5);
  * the parameters, in units of the learning rate (1e-4): Adam moves
    each parameter by about lr a step, whatever the gradient's size, so
    a parameter whose gradient the two packages compute differently by
    more than its own size moves differently by up to 2 lr.
    - TCN and HDemucs: 0.1 lr after three steps (measured 0.0018 lr and
      0.026 lr).
    - Mini-DCUNet-6: 1 lr after one step and 3 lr after three (measured
      0.7 lr and 1.8 lr), with at most 0.1% of the 91,744 elements beyond
      0.5 lr (measured 0 and 0.03%; 99% within 0.12 lr after three). Its
      deep layers' gradients differ by up to 0.7% of their largest
      element: against a float64 run of the same weights, the JAX
      package's fp32 gradient is off by 7.0e-3 of the layer's largest
      gradient and the port's by 1.1e-4, so the JAX side carries it;
  * the DCUNet's running statistics (flax's update, the biased batch
    variance): 1e-4 of their largest value (measured 4.2e-5 after three
    steps).

The clip, AdamW and the schedule against optax on a toy tree: 1e-6
relative. MultiSteps accumulation: the parameters unchanged on the first
k-1 micro-batches and equal to optax's (1e-6 relative) on the k-th.
bf16-mixed, one step of each of the TCN, HDemucs, the Mini-DCUNet-6,
UMX (hidden 64, the LSTM's dropout 0 on both sides) and DPTNet (chunk 20,
one repeat). Its bf16 convolutions run under the port's own guard
(``RemovalTask`` enters ``utils/device.py:cpu_bf16_convolutions`` around
the loss and its backward pass): oneDNN's bf16 convolutions are wrong for
some shapes on a CPU with AMX, and with them HDemucs's step moved 22.9% of
its elements beyond 0.5 lr from the JAX package's and 23.5% from the
port's own fp32 step, the gradients of its deep layers as far from fp32's
as their own norm. The measurements below were taken under the guard. The
loss to 2^-8 relative, one bf16 ulp, of the JAX package's (measured
8.0e-6, 9.9e-6, 1.5e-5, 1.0e-4 and 5.7e-5; the port's STFTs run in fp32
where JAX's DFT runs in bf16) and of the port's own fp32 step's from the
same weights (measured 1.9e-4, 1.7e-5, 6.9e-4, 1.2e-4 and 8.2e-5). The
parameters after the step, against the JAX package's bf16-mixed step's
and against the port's own fp32 step's, each within 2.05 lr (a first
Adam step of either sign: measured 2.0 lr in each, where a bf16
gradient's sign differs) with at most a share of the elements beyond 0.5
lr: the TCN 2% (measured 3 and 5 of 601), HDemucs 12% (8.1% and 8.3% of
28,627; the JAX package's own bf16 step moves 8.6% from its fp32 step),
the DCUNet 12% (7.9% and 9.4% of 91,744), UMX 12% (8.5% and 11.9% of
118,150: its LSTM and linear layers run on oneDNN's bf16 kernels, which
the guard leaves alone; with oneDNN off for the process, as before the
guard, 9.3% and 10.9%) and DPTNet 2% (0.06% and 0.26% of 1,433,025);
the running statistics (fp32 here, rounded to bf16 by the JAX package)
within 2e-2 of their largest value (measured 1.7e-3 for the DCUNet,
1.3e-2 for UMX).
The classifier's losses and metrics on the same probabilities: 1e-6
relative.
"""

import copy
import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from remfx_tpu.config import core as jcore
from remfx_tpu.config import experiments as jexp
from remfx_tpu.models import cnn14 as jcnn14
from remfx_tpu.models import lstm as jlstm
from remfx_tpu.models import umx as jumx
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.train import metrics as jmetrics
from remfx_tpu.train import tasks as jtasks
from remfx_tpu_torch.compat import from_jax
from remfx_tpu_torch.config import core as tcore
from remfx_tpu_torch.config import experiments as texp
from remfx_tpu_torch.models import cnn14 as tcnn14
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.models.batchnorm import BatchNorm2d
from remfx_tpu_torch.train import metrics as tmetrics
from remfx_tpu_torch.train import tasks as ttasks
from remfx_tpu_torch.train.checkpoint import (CheckpointManager, find_latest_run,
                                              read_state)
from remfx_tpu_torch.train import loop as tloop
from remfx_tpu_torch.train.loop import build_task, fit

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SR = 48000
LR = 1e-4
STEPS = 3
CASES = {
    "tcn": (dict(nblocks=3, channel_width=8, kernel_size=3, dilation_growth=2),
            from_jax.tcn_state_dict, 4096, 0.1, 0.1),
    "demucs": (dict(sources=["mixture"], audio_channels=1, channels=8, nfft=64,
                    depth=3), from_jax.demucs_state_dict, 4096, 0.1, 0.1),
    "dcunet": (dict(architecture="Mini-DCUNet-6", stft_kernel_size=64,
                    norm_type="bN"), from_jax.dcunet_state_dict, 4000, 1.0, 3.0),
}


def _batch(T, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((2, 1, T)) * np.linspace(0.2, 1.0, T)
    return x.astype(np.float32), (0.5 * np.tanh(2 * x)).astype(np.float32)


def _jax_variables(state):
    v = {"params": jax.device_get(state.params)}
    if state.batch_stats is not None:
        v["batch_stats"] = jax.device_get(state.batch_stats)
    return v


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request):
    """Three train steps on each side: per step the metrics and both
    sides' state dicts (the JAX one through the bridge)."""
    name = request.param
    net, bridge, T, _, _ = CASES[name]
    x, y = _batch(T)
    jw = jax_make_model(name, sample_rate=SR, **net)
    jtask = jtasks.RemovalTask(jw, max_steps=100)
    jstate = jtask.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    if jstate.batch_stats is not None:  # running statistics away from (0, 1)
        rng = np.random.default_rng(3)
        jstate = jstate.replace(batch_stats=jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jstate.batch_stats))
    wrapper = make_model(name, sample_rate=SR, device="cpu", **net)
    wrapper.module.load_state_dict(bridge(_jax_variables(jstate)), strict=True)
    task = ttasks.RemovalTask(wrapper, max_steps=100)
    state = task.init_state()
    out = []
    for i in range(STEPS):
        jstate, jm = jtask.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)),
                                      jax.random.PRNGKey(i))
        state, m = task.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        out.append({"jax_metrics": {k: float(v) for k, v in jm.items()},
                    "metrics": {k: float(v) for k, v in m.items()},
                    "jax_sd": _np(bridge(_jax_variables(jstate))),
                    "sd": _np(wrapper.module.state_dict())})
    return name, out


def test_train_step_loss_and_metrics_match_jax(steps):
    name, out = steps
    for i, s in enumerate(out):
        want, got = s["jax_metrics"], s["metrics"]
        assert set(got) == set(want)
        loss_rel = abs(got["train_loss"] - want["train_loss"]) / abs(want["train_loss"])
        assert loss_rel <= 1e-5, (name, i, loss_rel)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (name, i, k)


@pytest.mark.parametrize("after", [1, STEPS])
def test_train_step_parameters_match_jax(steps, after):
    """The parameters, and the DCUNet's running statistics as flax updates
    them (1e-4 of their largest value)."""
    name, out = steps
    one, three = CASES[name][3:]
    tol = (one if after == 1 else three) * LR
    s = out[after - 1]
    errs = []
    for k, want in s["jax_sd"].items():
        if "running" in k:
            assert np.abs(s["sd"][k] - want).max() <= 1e-4 * np.abs(want).max(), k
        elif "num_batches" in k:
            assert int(s["sd"][k]) == after, k
        else:
            errs.append(np.abs(s["sd"][k] - want).ravel())
    errs = np.concatenate(errs)
    assert errs.max() <= tol, (name, after, errs.max() / LR)
    assert np.mean(errs > 0.5 * LR) <= 1e-3, (name, after, np.mean(errs > 0.5 * LR))


def test_batchnorm_trains_as_flax_and_keeps_torch_eval():
    """Train mode: flax's output and running statistics (biased variance);
    eval mode: bit for bit torch's BatchNorm2d."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 5, 6)) * 2 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = bn.init(jax.random.PRNGKey(0), xh)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, upd = bn.apply(v, xh, mutable=["batch_stats"])
    port = BatchNorm2d(3, eps=1e-5, momentum=0.1)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0),
                          "num_batches_tracked": torch.tensor(0)})
    got = port.train()(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    ref = torch.nn.BatchNorm2d(3)
    ref.load_state_dict(port.state_dict())
    with torch.no_grad():
        assert torch.equal(port.eval()(torch.from_numpy(x)), ref.eval()(torch.from_numpy(x)))


def test_complex_batchnorm_trains_as_jax():
    from remfx_tpu.models import dcunet as jd
    from remfx_tpu_torch.models import dcunet as td
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue_plain

    rng = np.random.default_rng(1)
    xr, xi = (rng.standard_normal((2, 4, 5, 6)).astype(np.float32) for _ in range(2))
    jm = jd.ComplexBatchNorm()
    nhwc = [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (xr, xi)]
    v = jm.init(jax.random.PRNGKey(0), *nhwc, True)
    (yr, yi), upd = jm.apply(v, *nhwc, True, mutable=["batch_stats"])
    port = td.ComplexBatchNorm(4).train()
    x = torch.from_numpy(np.concatenate([xr, xi], 1))  # packed: re, im
    y = dcunet_epilogue_plain(x, port.coefficients(x), slope=1.0)  # the norm alone
    for g, w in ((y[:, :4], yr), (y[:, 4:8], yi)):
        np.testing.assert_allclose(g.detach().numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   rtol=0, atol=1e-5)
    for k in ("running_mean", "running_covar"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]), rtol=0, atol=1e-6)


# ------------------------------------------------------------ the optimizer

def _toy(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 3), "b": (3,), "s": ()}
    return {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}


def _params(tree):
    return [torch.nn.Parameter(torch.from_numpy(np.array(v))) for v in tree.values()]


def _close(got, want, rtol=1e-6):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= rtol * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("scale", [0.1, 100.0])
def test_clip_matches_optax(scale):
    g = {k: np.asarray(scale * v, np.float32) for k, v in _toy().items()}
    want, _ = optax.clip_by_global_norm(10.0).update(
        jax.tree.map(jnp.asarray, g), optax.EmptyState())
    got = [torch.from_numpy(np.array(v)) for v in g.values()]
    norm = ttasks.clip_by_global_norm_(got, 10.0)
    assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-6 * float(norm)
    _close([t.numpy() for t in got], [want[k] for k in g])


def test_adamw_and_schedule_match_optax():
    """Eight updates at max_steps 6: the milestones int(0.8*6) = 4 and
    int(0.95*6) = 5 are passed, so both LR drops take effect."""
    p0, max_steps = _toy(0), 6
    tx = jtasks.multistep_adamw(1e-2, max_steps)
    jp = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    params = _params(p0)
    opt, sched = ttasks.multistep_adamw(params, 1e-2, max_steps)
    task = ttasks._Optimizing()
    state = ttasks.TrainState(torch.nn.ParameterList(params), opt, sched)
    for i in range(8):
        g = {k: 3.0 * v for k, v in _toy(i + 1).items()}
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, v in zip(params, g.values()):
            p.grad = torch.from_numpy(np.array(v))
        task._apply_gradients(state)
        _close([p.detach().numpy() for p in params], [jp[k] for k in p0])
    assert ttasks.milestones(max_steps) == [4, 5]
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-4, rel=1e-6)


def test_multisteps_accumulation_matches_optax():
    k, max_steps = 3, 10
    p0 = _toy(0)
    tx = optax.MultiSteps(jtasks.multistep_adamw(1e-2, max_steps), every_k_schedule=k)
    jp = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    params = _params(p0)
    opt, sched = ttasks.multistep_adamw(params, 1e-2, max_steps)
    task = ttasks._Optimizing()
    task.accumulate_grad_batches = k
    state = ttasks.TrainState(torch.nn.ParameterList(params), opt, sched)
    for i in range(2 * k):
        g = {kk: v for kk, v in _toy(i + 1).items()}
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.detach().clone() for p in params]
        for p, v in zip(params, g.values()):
            p.grad = torch.from_numpy(np.array(v))
        task._apply_gradients(state)
        assert state.mini_step == int(opt_state.mini_step)
        if (i + 1) % k:
            assert all(torch.equal(a, p.detach()) for a, p in zip(before, params))
        _close([p.detach().numpy() for p in params], [jp[kk] for kk in p0])
    assert state.step == 2 * k and sched.last_epoch == int(opt_state.gradient_step) == 2


# bf16-mixed: name -> (network, bridge, T, the share of parameter elements
# allowed beyond 0.5 lr); the module docstring gives the measurements
BF16_CASES = {
    "tcn": (*CASES["tcn"][:3], 0.02),
    "demucs": (*CASES["demucs"][:3], 0.12),
    "dcunet": (*CASES["dcunet"][:3], 0.12),
    "umx": (dict(n_fft=512, hop_length=256, hidden_size=64), from_jax.umx_state_dict,
            4096, 0.12),
    "dptnet": (dict(chunk_size=20, n_repeats=1), from_jax.dptnet_state_dict, 4096, 0.02),
}


def _no_dropout_lstm(*args, **kwargs):
    kwargs["dropout"] = 0.0
    return jlstm.LSTM(*args, **kwargs)


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_mixed_step_matches_jax(name, monkeypatch):
    net, bridge, T, moved = BF16_CASES[name]
    if name == "umx":  # dropout 0 on both sides, as tests/test_torch_umx.py
        monkeypatch.setattr(jumx, "LSTM", _no_dropout_lstm)
    x, y = _batch(T, seed=1)
    jw = jax_make_model(name, sample_rate=SR, **net)
    jtask = jtasks.RemovalTask(jw, max_steps=100, precision="bf16-mixed")
    jstate = jtask.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    wrapper = make_model(name, sample_rate=SR, device="cpu", **net)
    wrapper.module.load_state_dict(bridge(_jax_variables(jstate)), strict=True)
    if name == "umx":
        wrapper.module.model.lstm.dropout = 0.0
    ref = copy.deepcopy(wrapper)
    ref_task = ttasks.RemovalTask(ref, max_steps=100)
    _, ref_m = ref_task.train_step(ref_task.init_state(),
                                   (torch.from_numpy(x), torch.from_numpy(y)))
    task = ttasks.RemovalTask(wrapper, max_steps=100, precision="bf16-mixed")
    state = task.init_state()
    jstate, jm = jtask.train_step(jstate, (jnp.asarray(x), jnp.asarray(y)),
                                  jax.random.PRNGKey(0))
    state, m = task.train_step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert all(p.dtype == torch.float32 and p.grad is None for p in wrapper.parameters())
    want = float(jm["train_loss"])
    jsd, sd = _np(bridge(_jax_variables(jstate))), _np(wrapper.module.state_dict())
    errs = np.concatenate([np.abs(sd[k] - jsd[k]).ravel() for k in jsd
                           if "running" not in k and "num_batches" not in k])
    assert abs(float(m["train_loss"]) - want) <= 2.0 ** -8 * abs(want)
    fp32 = float(ref_m["train_loss"])
    assert abs(float(m["train_loss"]) - fp32) <= 2.0 ** -8 * abs(fp32)
    rsd = _np(ref.module.state_dict())
    own = np.concatenate([np.abs(sd[k] - rsd[k]).ravel() for k in jsd
                          if "running" not in k and "num_batches" not in k])
    assert errs.max() <= 2.05 * LR and np.mean(errs > 0.5 * LR) <= moved
    assert own.max() <= 2.05 * LR and np.mean(own > 0.5 * LR) <= moved
    for k in jsd:  # the running statistics, fp32 here, rounded to bf16 by JAX
        if "running" in k:
            assert np.abs(sd[k] - jsd[k]).max() <= 2e-2 * np.abs(jsd[k]).max(), k


# ------------------------------------------------------------ the classifier

def _probs_labels(seed=0, n=16, c=5):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32)
    probs[0, 0], probs[1, 1] = 0.0, 1.0  # the clip at eps
    labels = (rng.uniform(0, 1, (n, c)) > 0.5).astype(np.float32)
    return probs, labels


@pytest.mark.parametrize("loss_type", ["bce", "ce"])
def test_classifier_losses_and_metrics_match_jax(loss_type):
    probs, labels = _probs_labels()
    if loss_type == "ce":
        probs = (4 * probs - 2).astype(np.float32)  # logits
    jt = jtasks.ClassifierTask(None, loss_type=loss_type, label_smoothing=0.1)
    tt = ttasks.ClassifierTask(None, loss_type=loss_type, label_smoothing=0.1)
    _, want = jt._loss_and_metrics(jnp.asarray(probs), jnp.asarray(labels), "valid")
    _, got = tt._loss_and_metrics(torch.from_numpy(probs), torch.from_numpy(labels),
                                  "valid")
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-6 * max(abs(w), 1.0), k


def test_metrics_match_jax():
    probs, labels = _probs_labels(1, n=9)
    for avg in (None, "macro"):
        np.testing.assert_allclose(
            tmetrics.multilabel_f1(torch.from_numpy(probs), torch.from_numpy(labels),
                                   average=avg).numpy(),
            np.asarray(jmetrics.multilabel_f1(jnp.asarray(probs), jnp.asarray(labels),
                                              average=avg)), rtol=1e-6)
    assert float(tmetrics.binary_accuracy(torch.from_numpy(probs), torch.from_numpy(labels))) \
        == pytest.approx(float(jmetrics.binary_accuracy(jnp.asarray(probs),
                                                        jnp.asarray(labels))), rel=1e-6)


def test_mixup_arithmetic_matches_jax_given_its_draws():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    y = (rng.uniform(0, 1, (4, 5)) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    for seed in range(6):  # both sides of the coin
        key = jax.random.PRNGKey(seed)
        want_x, want_y = jtasks.mixup(key, jnp.asarray(x), jnp.asarray(y))
        k1, k2, k3 = jax.random.split(key, 3)
        lam = np.array(jax.random.uniform(k1, (4, 1, 1), minval=0.25, maxval=0.75))
        index = np.array(jax.random.permutation(k2, 4))
        do = bool(jax.random.uniform(k3, ()) > 0.5)
        got_x, got_y = ttasks.mixup_from_draws(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(lam),
            torch.from_numpy(index), torch.tensor(do))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_mixup_draws_have_their_properties():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 1, 32, generator=g)
    y = (torch.rand(8, 5, generator=g) > 0.5).float()
    mixed = 0
    for _ in range(40):
        mx, my = ttasks.mixup(g, x, y)
        if torch.equal(mx, x):
            assert torch.equal(my, y)
            continue
        mixed += 1
        assert bool((my >= y).all())  # labels OR-ed
    assert 8 <= mixed <= 32  # p = 0.5


def test_specaugment_masks_match_jax_given_their_draws():
    key = jax.random.PRNGKey(3)
    for length, param in ((128, 64), (513, 128), (20, 64)):
        for k in jax.random.split(key, 4):
            want = np.asarray(jcnn14._rand_mask(k, length, param))
            k1, k2 = jax.random.split(k)
            width = jax.random.uniform(k1, (), minval=0.0, maxval=float(param))
            u = jax.random.uniform(k2, (), minval=0.0, maxval=1.0)
            got = tcnn14.mask_from_draws(torch.tensor([float(width)]),
                                         torch.tensor([float(u)]), length)[0]
            np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((2, 6, 9)).astype(np.float32)
    fm, tm = rng.uniform(size=(2, 6)) > 0.5, rng.uniform(size=(2, 9)) > 0.5
    want = np.where(tm[:, None, :], 0.0, np.where(fm[:, :, None], 0.0, m))
    got = tcnn14.apply_masks(torch.from_numpy(m), torch.from_numpy(fm), torch.from_numpy(tm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_specaugment_masks_in_train_mode_only():
    torch.manual_seed(0)
    kw = dict(n_fft=256, hop_length=128, n_mels=32, sample_rate=SR,
              model_sample_rate=SR, device="cpu")
    plain, aug = make_cnn14(**kw), make_cnn14(specaugment=True, **kw)
    aug.load_state_dict(plain.state_dict())
    x = torch.randn(3, 1, 16384, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(aug.front_end(x), plain.front_end(x))  # eval
        aug.train()
        masked = aug.front_end(x, torch.Generator().manual_seed(2))
        again = aug.front_end(x, torch.Generator().manual_seed(2))
    assert torch.equal(masked, again)
    assert not torch.equal(masked, plain.front_end(x))
    # the masked cells were zeros before the standardisation: one value
    # per example, its most common
    for row in masked:
        _, counts = torch.unique(row, return_counts=True)
        assert counts.max() >= row.shape[1]  # at least one masked band
    g = torch.Generator().manual_seed(5)
    fm, tm = tcnn14.draw_masks(g, 2000, 128, 513, 64, 128)
    widths = fm.sum(1).float()
    assert widths.max() <= 64 and 20 < widths.mean() < 44  # ~U[0, 64)
    assert tm.sum(1).max() <= 128


def test_make_cnn14_takes_the_specaugment_keys():
    net = make_cnn14(specaugment=True, freq_mask_param=8, time_mask_param=16,
                     device="cpu")
    assert (net.specaugment, net.freq_mask_param, net.time_mask_param) == (True, 8, 16)


# ---------------------------------------------------------------- the config

def test_experiments_equal_the_jax_experiments():
    assert sorted(texp.EXPERIMENTS) == sorted(jexp.EXPERIMENTS)
    assert texp.MODEL_CONFIGS == jexp.MODEL_CONFIGS
    for name in jexp.EXPERIMENTS:
        want, got = jexp.EXPERIMENTS[name](), texp.EXPERIMENTS[name]()
        assert want.pop("accelerator") == "tpu" and got.pop("accelerator") == "gpu"
        assert got == want, name


def test_parse_cli_equals_the_jax_cli():
    argv = ["+exp=compression_aug", "datamodule.dataset_type=dynamic",
            "datamodule.synthetic=true", "trainer.max_steps=8",
            "effects_to_keep=[reverb,delay]", "model=tcn", "accelerator=cpu"]
    assert tcore.parse_cli(argv) == jcore.parse_cli(argv)
    assert tcore.default_config() == jcore.default_config()


@pytest.mark.parametrize("model", ["umx", "dptnet", "cls_panns_pt"])
def test_unported_models_raise(model):
    """Once unported, each builds its task now: UMX and DPTNet their removal
    task (tests/test_torch_umx.py, test_torch_dptnet.py), ``cls_panns_pt``
    its classifier task on the frozen Cnn14 trunk
    (tests/test_torch_embedding.py)."""
    cfg = tcore.parse_cli(["+exp=5-5_full_cls", f"model={model}", "accelerator=cpu"])
    if model == "cls_panns_pt":
        task = build_task(cfg)
        assert isinstance(task, ttasks.ClassifierTask) and task.loss_type == "ce"
        assert all(k.startswith("proj.") for k in task.network.state_dict())
        return
    task = build_task(cfg)
    assert isinstance(task, ttasks.RemovalTask) and task.wrapper.name == model


def test_more_than_one_device_raises():
    """More devices than there are raise, naming ``devices``, before any
    rank starts (two CPU ranks train: tests/test_torch_parallel_fit.py)."""
    cfg = tcore.parse_cli(["+exp=distortion", "accelerator=cpu", "trainer.devices=100000"])
    with pytest.raises(ValueError, match="devices"):
        fit(cfg)
    with pytest.raises(ValueError, match="devices"):
        tloop.test({**cfg, "train": False})


def test_entry_point_defaults_to_the_card():
    """``python -m remfx_tpu_torch.train`` asks for the card; without one it
    raises, and it runs on the CPU only when the config names it."""
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "import runpy, sys; sys.argv = ['train', '+exp=distortion']\n"
            "runpy.run_module('remfx_tpu_torch.train', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    cfg = tcore.parse_cli(["+exp=distortion"])
    assert cfg["accelerator"] == "gpu"


# ------------------------------------------------------------------ the loop

def _tiny(tmp_path, *extra):
    return tcore.parse_cli(
        ["+exp=distortion", "model.name=tcn", "model.network.nblocks=3",
         "model.network.channel_width=8", "model.network.kernel_size=3",
         "model.network.dilation_growth=2", "accelerator=cpu",
         "datamodule.synthetic=true", "datamodule.dataset_type=dynamic",
         "datamodule.train_chunks=4", "datamodule.val_chunks=2",
         "datamodule.test_chunks=2", "datamodule.train_batch_size=2",
         "datamodule.test_batch_size=2", "chunk_size=8192", "log_audio=false",
         f"render_root={tmp_path / 'data'}"] + list(extra))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _fit_logged(cfg):
    h = _Records()
    lg = logging.getLogger("remfx_tpu_torch.train.loop")
    lg.addHandler(h)
    try:
        return fit(cfg), h.messages
    finally:
        lg.removeHandler(h)


def test_fit_then_test_restores_best(tmp_path):
    cfg = _tiny(tmp_path, f"logs_dir={tmp_path}", "trainer.max_steps=4",
                "trainer.max_epochs=2", "log_audio=true", "profile=true")
    state, metrics = fit(cfg)
    assert np.isfinite(metrics["test_loss"]) and "Input_SISDR" in metrics
    run = find_latest_run(str(tmp_path))
    for name in ("best", "last"):
        assert (run / name / "state.pt").is_file()
    assert json.loads((run / "last_meta.json").read_text())["step"] == 4
    best = read_state(str(run / "best"))["model"]
    assert all(torch.equal(best[k], v) for k, v in state.model.state_dict().items())
    again = tloop.test(_tiny(tmp_path, f"logs_dir={tmp_path}", "render_files=false",
                       f"ckpt_path={run / 'best'}"))
    assert again == pytest.approx(metrics, rel=1e-6)
    assert list(tmp_path.rglob("metrics.csv"))
    # the audio log of each validation: prediction, input and target
    wavs = sorted(tmp_path.rglob("valid_pred_input_target_step*.wav"))
    assert [w.name for w in wavs] == ["valid_pred_input_target_step2.wav",
                                      "valid_pred_input_target_step4.wav"]
    assert (tmp_path / "profile" / "trace.json").is_file()


def test_wandb_logger_offline_fallback(tmp_path):
    """WandbLogger degrades to JSONL + CSV when wandb is absent."""
    from remfx_tpu_torch.train.loggers import WandbLogger, make_logger

    lg = make_logger("wandb", str(tmp_path))
    assert isinstance(lg, WandbLogger)
    lg.log_hyperparams({"a": 1})
    lg.log_metrics({"loss": 2.5}, step=1)
    lg.log_audio("probe", np.zeros((1, 100), np.float32), 48000, 1)
    lg.close()
    events = [json.loads(line) for line in (lg.dir / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["hparams", "metrics", "audio"]
    assert (lg.dir / "metrics.csv").stat().st_size > 0
    assert list((lg.dir / "audio").glob("*.wav"))


def test_timeit_and_heartbeat(tmp_path, monkeypatch):
    """The heartbeat touches ``$REMFX_HEARTBEAT``; without it, it does nothing."""
    from remfx_tpu_torch.utils import heartbeat

    beat = tmp_path / "beat"
    monkeypatch.setenv("REMFX_HEARTBEAT", str(beat))
    monkeypatch.setattr(heartbeat, "_checked", False)
    heartbeat.beat()
    assert beat.is_file()
    monkeypatch.setattr(heartbeat, "_checked", False)
    monkeypatch.delenv("REMFX_HEARTBEAT")
    heartbeat.beat()


def test_auto_resume_from_last(tmp_path):
    cfg = _tiny(tmp_path, f"logs_dir={tmp_path}", "trainer.max_steps=2",
                "trainer.max_epochs=1")
    fit(cfg)
    cfg2 = _tiny(tmp_path, f"logs_dir={tmp_path}", "trainer.max_steps=3",
                 "trainer.max_epochs=2", "trainer.auto_resume=true",
                 "render_files=false")
    (state, metrics), records = _fit_logged(cfg2)
    assert any("auto-resumed" in m and "step 2 epoch 1" in m for m in records), records
    assert np.isfinite(metrics["test_loss"])
    meta = json.loads((find_latest_run(str(tmp_path)) / "last_meta.json").read_text())
    assert (meta["step"], meta["epoch"]) == (3, 2)
    assert state.step == 3


def test_auto_resume_skips_foreign_run_tag(tmp_path):
    fit(_tiny(tmp_path, f"logs_dir={tmp_path}", "trainer.max_steps=1",
              "trainer.max_epochs=1"))
    meta_path = find_latest_run(str(tmp_path)) / "last_meta.json"
    meta = json.loads(meta_path.read_text())
    meta["run_tag"] = "demucs|removal|compressor|"
    meta_path.write_text(json.dumps(meta))
    (state, _), records = _fit_logged(_tiny(
        tmp_path, f"logs_dir={tmp_path}", "trainer.max_steps=1", "trainer.max_epochs=1",
        "trainer.auto_resume=true", "render_files=false"))
    assert any("different run" in m for m in records), records
    assert not any("auto-resumed" in m for m in records)
    assert state.step == 1


def test_find_latest_run_repairs_interrupted_save(tmp_path):
    root = tmp_path / "ckpts"
    r2 = root / "2026-01-02-00-00-00"
    r2.mkdir(parents=True)
    (r2 / "last_meta.json").write_text('{"step": 7}')
    (r2 / "last.tmp").mkdir()
    (r2 / "last.tmp" / "d").write_text("new")
    (r2 / "last.old").mkdir()
    assert find_latest_run(str(tmp_path)) == r2
    assert (r2 / "last" / "d").read_text() == "new"
    assert not (r2 / "last.tmp").exists()
    r3 = root / "2026-01-03-00-00-00"
    r3.mkdir()
    (r3 / "last_meta.json").write_text('{"step": 9}')
    (r3 / "last.old").mkdir()
    (r3 / "last.old" / "d").write_text("old")
    assert find_latest_run(str(tmp_path)) == r3
    assert (r3 / "last" / "d").read_text() == "old"
    r4 = root / "2026-01-04-00-00-00"
    r4.mkdir()
    (r4 / "last_meta.json").write_text('{"step": 11}')
    assert find_latest_run(str(tmp_path)) == r3


def test_atomic_last_save_layout(tmp_path):
    w = torch.nn.Linear(2, 2)
    opt, _ = ttasks.multistep_adamw(w.parameters(), 1e-3, -1)
    state = ttasks.TrainState(w, opt)
    cm = CheckpointManager(str(tmp_path / "run"))
    cm.save_last(state, step=1)
    with torch.no_grad():
        w.weight.mul_(2)
    cm.save_last(state, step=2)
    d = tmp_path / "run"
    assert sorted(p.name for p in d.iterdir()) == ["last", "last_meta.json"]
    saved = w.weight.detach().clone()
    with torch.no_grad():
        w.weight.zero_()
    cm.restore(state, "last")
    assert torch.equal(w.weight, saved)


def test_warm_start_params_only(tmp_path):
    state1, _ = fit(_tiny(tmp_path, f"logs_dir={tmp_path / 'a'}", "trainer.max_steps=2",
                          "trainer.max_epochs=1"))
    best = next((tmp_path / "a" / "ckpts").rglob("best"))
    (state2, metrics), records = _fit_logged(_tiny(
        tmp_path, f"logs_dir={tmp_path / 'b'}", f"warm_start={best}",
        "trainer.max_steps=1", "trainer.max_epochs=1", "render_files=false"))
    assert any("warm-started" in m for m in records), records
    assert np.isfinite(metrics["test_loss"])
    # a fresh optimizer: one update from the donor's weights
    assert state2.step == 1 and state2.scheduler.last_epoch == 1
    donor = read_state(str(best))["model"]
    moved = max((v - donor[k]).abs().max().item()
                for k, v in state2.model.state_dict().items())
    assert 0 < moved <= 1.5 * LR


def test_accumulation_counts_optimizer_steps_and_lr_drop_fires(tmp_path):
    """accumulate_grad_batches=k: max_steps counts optimizer steps (fit
    takes k micro-batches for each), and the LR drops at int(0.8 *
    max_steps) and int(0.95 * max_steps) take effect."""
    max_steps, k = 6, 2
    cfg = _tiny(tmp_path, f"logs_dir={tmp_path}", f"trainer.max_steps={max_steps}",
                "trainer.max_epochs=10", f"trainer.accumulate_grad_batches={k}",
                "datamodule.train_chunks=8")
    state, _ = fit(cfg)
    assert state.step == max_steps * k
    assert state.scheduler.last_epoch == max_steps
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6, rel=1e-6)
    meta = json.loads((find_latest_run(str(tmp_path)) / "last_meta.json").read_text())
    assert meta["step"] == max_steps
