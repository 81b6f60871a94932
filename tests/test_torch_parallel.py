"""The port's parallel layer (``remfx_tpu_torch/parallel``) against one
process and against the JAX package's mesh (``tests/test_parallel.py``).

The port runs one process per device: here 2 or 4 gloo ranks on the CPU,
started by ``parallel.launch.spawn`` (one thread a rank), each with a
join deadline. The JAX side runs on the conftest's 8 virtual CPU devices.

Train steps, on the setups of ``test_dp_training_step_8dev`` (TCN 3 x 16,
kernel 3, dilation growth 2; 16 x 1 x 4096, target x / 2; dp 2 against
JAX's dp 8) and ``test_dp_tp_sharded_step`` (8 x 1 x 4096; dp 2 x tp 2
with FSDP2 against JAX's dp 4 x tp 2), from JAX's initial weights:

  * the global batch's loss against the one-process step: 1e-6 relative
    (fp32 means of halves against the mean of the whole);
  * against the JAX mesh's step: 1e-5 relative, the one-step parity of
    ``tests/test_torch_train.py`` (bf16-mixed: 2^-8, one bf16 ulp, that
    file's bf16 bound);
  * the parameters after the step against the one-process step, in units
    of the learning rate (1e-4): 0.2 lr in fp32. In bf16-mixed a rank's
    bf16 gradient of its half of the batch rounds differently from the
    whole batch's, and a first Adam step moves an element by about lr
    whatever its gradient's size, so where the rounding flips a sign the
    element moves 2 lr the other way: 2.05 lr and at most 2% of the
    elements beyond 0.5 lr, the bound of the bf16 test of
    ``tests/test_torch_train.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.parallel import make_mesh as jax_make_mesh
from remfx_tpu.parallel import replicate as jax_replicate
from remfx_tpu.parallel import shard_batch as jax_shard_batch
from remfx_tpu.parallel import shard_tcn_params as jax_shard_tcn_params
from remfx_tpu.train import tasks as jtasks
from remfx_tpu_torch.compat.from_jax import tcn_state_dict
from remfx_tpu_torch.parallel import Rows, batch_rows, launch
from remfx_tpu_torch.parallel.steps import mesh_probe, removal_steps
from remfx_tpu_torch.train.loop import build_mesh

torch.set_num_threads(2)
NET = dict(nblocks=3, channel_width=16, kernel_size=3, dilation_growth=2)
LR = 1e-4
JOIN_S = 240  # deadline of a launch's join
# (dp, tp, precision) -> the JAX mesh and the batch of its tests/test_parallel.py setup
CASES = {
    "dp2": (2, 1, "32"), "dp2xtp2": (2, 2, "32"),
    "dp2-bf16": (2, 1, "bf16-mixed"), "dp2xtp2-bf16": (2, 2, "bf16-mixed"),
}
PARAM_TOL = {"32": (0.2, 0.0), "bf16-mixed": (2.05, 0.02)}  # (max lr, share > 0.5 lr)


def _setup(tp: int):
    rng = np.random.default_rng(12345)  # the conftest's rng fixture
    rows = 16 if tp == 1 else 8
    x = (rng.standard_normal((rows, 1, 4096)).astype(np.float32) * 0.1)
    return x, (x * 0.5).astype(np.float32)


def _jax_step(x, y, tp: int, precision: str):
    """JAX's step on its mesh (dp 8, or dp 4 x tp 2 with the TCN's
    channels sharded) -> (loss, initial variables)."""
    task = jtasks.RemovalTask(jax_make_model("tcn", **NET), max_steps=100,
                              precision=precision)
    state = task.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": jax.device_get(state.params)}
    mesh = jax_make_mesh(dp=8 // tp, tp=tp)
    sharded = jax_replicate(state, mesh)
    if tp > 1:
        sharded = sharded.replace(params=jax_shard_tcn_params(sharded.params, mesh))
    batch = jax_shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    _, metrics = task.train_step(sharded, batch, jax.random.PRNGKey(1))
    return float(metrics["train_loss"]), variables


@pytest.fixture(scope="module", params=sorted(CASES))
def step(request):
    dp, tp, precision = CASES[request.param]
    x, y = _setup(tp)
    jax_loss, variables = _jax_step(x, y, tp, precision)
    sd = {k: v.numpy() for k, v in tcn_state_dict(variables).items()}
    args = ("tcn", NET, sd, x, y, 1, tp, precision, "cpu")
    ranks = launch.spawn(removal_steps, dp * tp, *args, device_type="cpu",
                         timeout=JOIN_S)
    one = removal_steps("tcn", NET, sd, x, y, 1, 1, precision, "cpu")
    return request.param, jax_loss, ranks, one


def test_ranks_form_the_mesh_and_shard(step):
    name, _, ranks, one = step
    dp, tp, _ = CASES[name]
    assert [r["mesh"] for r in ranks] == [{"dp": dp, "tp": tp}] * (dp * tp)
    assert all(r["sharded"] == (tp > 1) for r in ranks) and one["mesh"] is None
    # every rank holds the global loss; rank 0 alone returns the weights
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert ranks[0]["state_dict"] is not None
    assert all(r["state_dict"] is None for r in ranks[1:])


def test_step_loss_equals_one_process(step):
    _, _, ranks, one = step
    got, want = ranks[0]["losses"][0], one["losses"][0]
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_step_loss_equals_the_jax_mesh(step):
    name, jax_loss, ranks, _ = step
    tol = 2.0 ** -8 if CASES[name][2] == "bf16-mixed" else 1e-5
    got = ranks[0]["losses"][0]
    assert abs(got - jax_loss) <= tol * abs(jax_loss), (got, jax_loss)


def test_step_parameters_equal_one_process(step):
    name, _, ranks, one = step
    bound, share = PARAM_TOL[CASES[name][2]]
    sd, want = ranks[0]["state_dict"], one["state_dict"]
    assert sorted(sd) == sorted(want)  # the module's own names, full tensors
    errs = np.concatenate([np.abs(sd[k] - want[k]).ravel() for k in want])
    assert errs.max() <= bound * LR, errs.max() / LR
    assert np.mean(errs > 0.5 * LR) <= share, np.mean(errs > 0.5 * LR)


def test_step_gradients_equal_one_process(step):
    """Adam's first moment after the step, 0.05 x the clipped averaged
    gradient, against one process, relative to each tensor's largest: 1e-4
    in fp32 (sums of halves against the sum of the whole, over 65536
    samples and back through the STFT loss; measured at most 1.5e-5), 1e-2
    in bf16-mixed (the ranks' bf16 gradients round apart by up to 2^-8 of
    their size). A wrong average (a sum, or one rank's) is off by a factor
    of the ranks."""
    name, _, ranks, one = step
    tol = 1e-2 if CASES[name][2] == "bf16-mixed" else 1e-4
    for got, want in zip(ranks[0]["exp_avg"], one["exp_avg"], strict=True):
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def probe():
    cfg = {"accelerator": "cpu", "trainer": {"devices": 4, "tensor_parallel": 2}}
    return launch.spawn(mesh_probe, 4, cfg, device_type="cpu", timeout=JOIN_S)


def test_build_mesh_uses_device_subset(probe):
    """``test_build_mesh_uses_device_subset``: trainer.devices=4 with
    tensor_parallel=2 is a (2, 2) mesh of exactly 4 devices; more devices
    than there are raise, naming ``devices``; one device is no mesh."""
    assert [p["shape"] for p in probe] == [{"dp": 2, "tp": 2}] * 4
    assert all(p["size"] == 4 for p in probe)
    assert [(p["dp_rank"], p["tp_rank"]) for p in probe] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="devices"):
        build_mesh({"trainer": {"devices": 1024}})
    with pytest.raises(ValueError, match="devices"):
        build_mesh({"accelerator": "cpu", "trainer": {"devices": 10 ** 6}})
    assert build_mesh({"trainer": {"devices": 1}}) is None


def test_shard_ragged_tail_batch_trims(probe):
    """``test_shard_ragged_tail_batch_trims``: a ragged batch (11 over dp 2)
    is trimmed to 10, 5 rows a rank, the same rows on both tp ranks; a
    batch smaller than dp (1) is replicated, not trimmed to nothing; in
    evaluation (strict off) a ragged batch is replicated."""
    for p in probe:
        r = p["dp_rank"]
        assert p["strict=True"][11] == [5 * r, 5 * r + 5, 10, True]
        assert p["strict=True"][1] == [0, 1, 1, False]
        assert p["strict=True"][8] == [4 * r, 4 * r + 4, 8, True]
        assert p["strict=False"][11] == [0, 11, 11, False]
        assert p["strict=False"][8] == [4 * r, 4 * r + 4, 8, True]
        xs, ys = p["shard_batch"]  # the dp coordinate's rows, on both tp ranks
        assert xs == list(range(4 * r, 4 * r + 4)) and ys == [10 * v for v in xs]


def test_rows_without_a_mesh_are_the_batch():
    rows = batch_rows(7)
    assert rows == Rows(0, 7, 7) and not rows.split
    x = np.arange(7)
    assert (rows.take(x) == x).all()


def test_a_failing_rank_fails_the_launch_naming_it():
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 failed(.|\n)*no-such-model"):
        launch.spawn(removal_steps, 2, "no-such-model", {}, {}, np.zeros((2, 1, 8)),
                     np.zeros((2, 1, 8)), device_type="cpu", timeout=JOIN_S)


def test_a_hanging_rank_fails_the_launch_at_its_deadline():
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 did not finish"):
        launch.spawn(time.sleep, 2, 600, device_type="cpu", timeout=3)


def test_a_torchrun_environment_is_a_rank(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not launch.from_torchrun()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert launch.from_torchrun()
