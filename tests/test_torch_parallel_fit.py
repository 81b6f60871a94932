"""Multi-device training of the port through ``fit`` and the tasks, on
gloo ranks on the CPU (``parallel.launch``, one thread a rank, a join
deadline each), against one process and against the JAX package.

``fit`` on ``tests/test_parallel.py::test_fit_multidevice_matches_single``'s
config (TCN 3 x 8, kernel 3; one epoch of one 8-row batch of 4096
samples, then the test set from the best checkpoint), with ``accelerator=cpu``:

  * the dynamic set: ``trainer.devices=2`` against one device, test_loss
    and test_SISDR within 1e-4 (each rank renders the one device's batch
    and keeps its rows);
  * against JAX: the port's dynamic render draws from a ``torch.Generator``
    where JAX draws from its own keys (``tests/test_torch_data.py``), so
    the two packages' dynamic batches differ by design. The comparison
    therefore trains on the offline set that the JAX package rendered,
    read by both (``render_files=false``), from JAX's initial weights (the
    port warm-starts from them): the port's one device against JAX's one
    device, and the port's 2 ranks against JAX's ``devices=8``, each within
    that test's 2e-3.

A 2-rank ``ClassifierTask`` step of Cnn14 with SpecAugment, mixup and
dropout equals one process: every draw over the batch is made at the
global batch's shape. The loss within 1e-6 relative and the BatchNorm
running statistics within 1e-6 of their largest value. The parameters in
units of the learning rate (1e-4): a first AdamW step (eps 1e-8) moves an
element by about lr whatever its gradient's size, so the few of Cnn14's
80 million elements whose gradient is below the rounding of the two sums
(the halves' and the whole's) move up to 2 lr apart: 2.05 lr, and at most
1e-5 of the elements beyond 0.5 lr (measured 1.27 lr and 15 elements,
1.9e-7). The port's
``BatchNorm2d`` on 2 ranks x 4 rows in train mode equals one process on 8
rows and flax's ``BatchNorm`` on 8 rows (outputs, running statistics and
gradients within 1e-6). A 2-rank run's checkpoint resumes in one process,
and a one-device run's on 2 ranks; the CLI trains on a dp 2 x tp 2 mesh
of four CPU ranks.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.config.core import parse_cli as jax_parse_cli
from remfx_tpu.train.loop import build_task as jax_build_task
from remfx_tpu.train.loop import fit as jax_fit
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.parallel import launch
from remfx_tpu_torch.parallel.steps import batchnorm_train, classifier_steps
from remfx_tpu_torch.train.checkpoint import find_latest_run, read_state, state_dict_from_jax
from remfx_tpu_torch.train.loop import build_task, fit

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 300
LR = 1e-4
FIT_ARGS = [
    "+exp=distortion", "model.name=tcn", "model.network.nblocks=3",
    "model.network.channel_width=8", "model.network.kernel_size=3",
    "model.network.dilation_growth=2", "datamodule.synthetic=true",
    "datamodule.train_chunks=8", "datamodule.val_chunks=2",
    "datamodule.test_chunks=2", "datamodule.train_batch_size=8",
    "datamodule.test_batch_size=2", "trainer.max_steps=2",
    "trainer.max_epochs=1", "chunk_size=4096", "log_audio=false",
]


def _port_cfg(tmp, tag, devices, *extra):
    return parse_cli(FIT_ARGS + ["accelerator=cpu", f"trainer.devices={devices}",
                                 f"logs_dir={tmp / tag}"] + list(extra))


@pytest.fixture(scope="module")
def dynamic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dynamic")
    one = fit(_port_cfg(tmp, "one", 1, "datamodule.dataset_type=dynamic",
                        f"render_root={tmp / 'data_one'}"))[1]
    two = fit(_port_cfg(tmp, "two", 2, "datamodule.dataset_type=dynamic",
                        f"render_root={tmp / 'data_two'}"))[1]
    return tmp, one, two


def test_fit_on_two_ranks_equals_one_device(dynamic):
    _, one, two = dynamic
    assert np.isfinite(two["test_loss"])
    for k in ("test_loss", "test_SISDR"):
        assert abs(two[k] - one[k]) <= 1e-4 * max(abs(one[k]), 1.0), (k, two[k], one[k])


def test_two_rank_checkpoint_resumes_in_one_process(dynamic):
    """Rank 0 wrote the checkpoints, under the module's own names; one
    process resumes the run at its step and trains on."""
    tmp, _, _ = dynamic
    run = find_latest_run(str(tmp / "two"))
    # one epoch of 8 chunks in batches of 8: one step
    assert json.loads((run / "last_meta.json").read_text())["step"] == 1
    saved = read_state(str(run / "last"))
    cfg = _port_cfg(tmp, "two", 1, "datamodule.dataset_type=dynamic",
                    f"render_root={tmp / 'data_two'}", "render_files=false",
                    "trainer.auto_resume=true", "trainer.max_epochs=2")
    assert set(saved["model"]) == set(build_task(cfg).init_state().model.state_dict())
    state, metrics = fit(cfg)
    assert state.step == 2 and np.isfinite(metrics["test_loss"])
    assert json.loads((find_latest_run(str(tmp / "two")) / "last_meta.json")
                      .read_text())["step"] == 2


def test_one_device_checkpoint_resumes_on_two_ranks(dynamic):
    tmp, _, _ = dynamic
    cfg = _port_cfg(tmp, "one", 2, "datamodule.dataset_type=dynamic",
                    f"render_root={tmp / 'data_one'}", "render_files=false",
                    "trainer.auto_resume=true", "trainer.max_epochs=2")
    _, metrics = fit(cfg)
    assert np.isfinite(metrics["test_loss"])
    assert json.loads((find_latest_run(str(tmp / "one")) / "last_meta.json")
                      .read_text())["step"] == 2


def test_cli_trains_on_a_dp_by_tp_mesh_of_cpu_ranks(tmp_path):
    """``python -m remfx_tpu_torch.train ... trainer.devices=4
    trainer.tensor_parallel=2 accelerator=cpu``: four gloo ranks on a (2,
    2) mesh train, validate and test; rank 0 alone logs."""
    argv = FIT_ARGS + ["accelerator=cpu", "trainer.devices=4", "trainer.tensor_parallel=2",
                       "datamodule.dataset_type=dynamic", f"logs_dir={tmp_path}",
                       f"render_root={tmp_path / 'data'}"]
    out = subprocess.run([sys.executable, "-m", "remfx_tpu_torch.train", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=JOIN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.count("multi-device training: mesh {'dp': 2, 'tp': 2}") == 1
    assert out.stderr.count("test: {") == 1
    run = find_latest_run(str(tmp_path))
    assert json.loads((run / "last_meta.json").read_text())["step"] == 1
    assert (run / "best" / "state.pt").is_file()


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """JAX's fits on one device and on 8 (the offline set it renders, read
    back by the 8-device run), and the port's on one device and on 2 ranks
    from the same files and JAX's initial weights."""
    tmp = tmp_path_factory.mktemp("against_jax")
    data = tmp / "data"

    def jax_run(devices, *extra):
        cfg = jax_parse_cli(FIT_ARGS + ["datamodule.dataset_type=offline",
                                        f"trainer.devices={devices}",
                                        f"logs_dir={tmp / f'jax{devices}'}"] + list(extra))
        cfg["render_root"] = str(data)
        return jax_fit(cfg)[1]

    j1 = jax_run(1)
    j8 = jax_run(8, "render_files=false")
    # JAX's fit initialises from the second half of split(PRNGKey(seed))
    jcfg = jax_parse_cli(FIT_ARGS + ["datamodule.dataset_type=offline"])
    k_init = jax.random.split(jax.random.PRNGKey(jcfg["seed"]))[1]
    jstate = jax_build_task(jcfg).init_state(k_init, jnp.zeros((8, 1, 4096), jnp.float32))
    donor = tmp / "donor"
    donor.mkdir()
    task = build_task(_port_cfg(tmp, "donor", 1))
    sd = state_dict_from_jax(task.wrapper, {"params": jax.device_get(jstate.params)})
    torch.save({"model": sd}, donor / "state.pt")
    port = {n: fit(_port_cfg(tmp, f"port{n}", n, "datamodule.dataset_type=offline",
                             f"render_root={data}", "render_files=false",
                             f"warm_start={donor}"))[1] for n in (1, 2)}
    return j1, j8, port


@pytest.mark.parametrize("devices,jax_devices", [(1, 1), (2, 8)])
def test_fit_matches_the_jax_fit(against_jax, devices, jax_devices):
    j1, j8, port = against_jax
    want = {1: j1, 8: j8}[jax_devices]
    got = port[devices]
    for k in ("test_loss", "test_SISDR"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3, err_msg=k)


# ------------------------------------------------------------ the classifier

CNN14 = dict(num_classes=5, sample_rate=48000, model_sample_rate=48000, n_fft=256,
             hop_length=128, n_mels=32, specaugment=True, freq_mask_param=8,
             time_mask_param=16)


def _mixup_fires(seed: int, rows: int) -> bool:
    """Whether the first mixup draw of ``ClassifierTask(seed=seed)`` mixes
    (its coin comes after lambda and the permutation)."""
    g = torch.Generator().manual_seed(seed)
    torch.rand(rows, 1, 1, generator=g)
    torch.randperm(rows, generator=g)
    return bool(torch.rand((), generator=g) > 0.5)


@pytest.fixture(scope="module")
def classifier():
    rows = 8
    seed = next(s for s in range(100) if _mixup_fires(s, rows))
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((rows, 1, 8192))).astype(np.float32)
    labels = (rng.uniform(size=(rows, 5)) > 0.5).astype(np.float32)
    torch.manual_seed(3)
    sd = {k: v.numpy() for k, v in make_cnn14(device="cpu", **CNN14).state_dict().items()}
    args = (CNN14, sd, x, labels, 1, seed, True, "cpu")
    ranks = launch.spawn(classifier_steps, 2, *args, device_type="cpu", timeout=JOIN_S)
    return ranks, classifier_steps(*args)


def test_classifier_step_on_two_ranks_equals_one_process(classifier):
    ranks, one = classifier
    got, want = ranks[0]["losses"][0], one["losses"][0]
    assert ranks[1]["losses"] == ranks[0]["losses"]
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    sd, want = ranks[0]["state_dict"], one["state_dict"]
    errs = []
    for k, v in want.items():
        if "running" in k:  # the global batch's statistics
            assert np.abs(sd[k] - v).max() <= 1e-6 * np.abs(v).max(), k
        elif "num_batches" in k:
            assert sd[k] == v == 1, k
        else:
            errs.append(np.abs(sd[k] - v).ravel())
    errs = np.concatenate(errs)
    assert errs.max() <= 2.05 * LR, errs.max() / LR
    assert np.mean(errs > 0.5 * LR) <= 1e-5, np.mean(errs > 0.5 * LR)


# -------------------------------------------------------------- BatchNorm2d

@pytest.fixture(scope="module")
def batchnorm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 3, 5, 6)) * 2 + 1).astype(np.float32)
    sd = {"weight": rng.uniform(0.5, 1.5, 3).astype(np.float32),
          "bias": rng.uniform(-0.5, 0.5, 3).astype(np.float32),
          "running_mean": rng.uniform(-0.2, 0.2, 3).astype(np.float32),
          "running_var": rng.uniform(0.5, 2.0, 3).astype(np.float32),
          "num_batches_tracked": np.zeros((), np.int64)}
    ranks = launch.spawn(batchnorm_train, 2, sd, x, "cpu", device_type="cpu",
                         timeout=JOIN_S)
    return x, sd, ranks, batchnorm_train(sd, x, "cpu")


def test_batchnorm_on_two_ranks_equals_one_process(batchnorm):
    _, _, ranks, one = batchnorm
    assert [r["rows"] for r in ranks] == [[0, 4], [4, 8]]
    for key in ("y", "grad"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, one[key], rtol=0, atol=1e-6, err_msg=key)
    for r in ranks:
        for key in ("running_mean", "running_var", "weight_grad"):
            np.testing.assert_allclose(r[key], one[key], rtol=1e-6, atol=1e-6,
                                       err_msg=key)


def test_batchnorm_on_two_ranks_equals_flax_on_the_batch(batchnorm):
    import flax.linen as fnn

    x, sd, ranks, _ = batchnorm
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": jnp.asarray(sd["weight"]), "bias": jnp.asarray(sd["bias"])},
         "batch_stats": {"mean": jnp.asarray(sd["running_mean"]),
                         "var": jnp.asarray(sd["running_var"])}}
    want, upd = bn.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    got = np.concatenate([r["y"] for r in ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"], np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["running_var"], np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-6)
