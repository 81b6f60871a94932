"""Fit/test loop — the Lightning-Trainer role, config-driven.

Counterpart of ``remfx_tpu/train/loop.py`` (the reference's
scripts/train.py:9-55): seed -> datamodule (rendering side-effect) ->
model/task -> fit with per-step logging, validation each epoch, best/last
checkpointing -> test with the best checkpoint.

The run's device comes from ``accelerator`` (``device_of``): ``"cpu"``
is the host; anything else is the card, and asking for it without one
raises.

``trainer.devices = N > 1`` is the JAX package's ``(dp, tp)`` mesh over N
devices (``tp = trainer.tensor_parallel``), run as one process per device
(``parallel/launch.py``: NCCL on the cards, gloo on the CPU). Called with
no process group, ``fit`` and ``test`` start N ranks and return rank 0's
metrics; in a rank (or under ``torchrun``) they run that rank's part:

  * data: every rank draws the one device's global batch and keeps its
    rows (``parallel.batch_rows``: ragged training batches trimmed to a
    ``dp`` multiple, batches smaller than ``dp`` and ragged evaluation
    batches replicated); the model is rank 0's, replicated, and sharded
    over ``tp`` by FSDP2 when ``tp > 1`` (``_shard_state``);
  * metrics: all-reduced as means, so every rank holds the global ones;
  * files: rank 0 alone renders the offline datasets, logs, and writes
    the checkpoints (full tensors under the module's names, so a run
    resumes on another number of devices); the other ranks wait for it.
"""

from __future__ import annotations

import json
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from remfx_tpu_torch.data.datasets import (
    DynamicEffectDataset,
    EffectDatamodule,
    EffectDataset,
    InferenceDataset,
)
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.models.embedding_classifiers import make_embedding_classifier
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.parallel import launch
from remfx_tpu_torch.parallel.mesh import (all_reduce_mean_, batch_rows, make_mesh,
                                           mesh_shape, replicate, shard_params_channels,
                                           shard_tcn_params)
from remfx_tpu_torch.train import checkpoint
from remfx_tpu_torch.train.checkpoint import CheckpointManager, find_latest_run, restore_from
from remfx_tpu_torch.train.loggers import make_logger
from remfx_tpu_torch.train.tasks import ClassifierTask, RemovalTask
from remfx_tpu_torch.utils import heartbeat
from remfx_tpu_torch.utils.crop import causal_crop
from remfx_tpu_torch.utils.device import resolve_device
from remfx_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _device_type(cfg: dict) -> str:
    return "cpu" if cfg.get("accelerator") == "cpu" else "cuda"


def device_of(cfg: dict) -> torch.device:
    """``accelerator: cpu`` -> the host; anything else -> the card (in a
    process group, this rank's: ``cuda:{local rank}``)."""
    if _device_type(cfg) == "cuda" and dist.is_initialized():
        return resolve_device(torch.device("cuda", torch.cuda.current_device()))
    return resolve_device("cpu" if _device_type(cfg) == "cpu" else None)


def _devices(cfg: dict) -> int:
    return int(cfg["trainer"].get("devices", 1) or 1)


def build_mesh(cfg: dict):
    """``trainer.devices > 1`` -> a ``(dp, tp)`` mesh over exactly that many
    of the devices present (``tp = trainer.tensor_parallel``), one rank
    each; None for one device outside a process group."""
    devices = _devices(cfg)
    tp = int(cfg["trainer"].get("tensor_parallel", 1) or 1)
    if devices <= 1 and not dist.is_initialized():
        return None
    launch.check_devices(devices, _device_type(cfg))
    if not dist.is_initialized():
        raise RuntimeError(f"trainer.devices={devices} runs one process per device: "
                           "start it through fit / test or under torchrun")
    if dist.get_world_size() != devices:
        raise ValueError(f"trainer.devices={devices} but the process group has "
                         f"{dist.get_world_size()} ranks")
    return make_mesh(dp=devices // tp, tp=tp)


def _spawns(cfg: dict) -> bool:
    """Whether this call starts the ranks (more than one device asked for,
    and this process is not one of a group)."""
    return _devices(cfg) > 1 and not dist.is_initialized()


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _from_rank0(fn):
    """``fn()`` computed by rank 0 alone and handed to every rank."""
    value = [fn() if _rank0() else None]
    if dist.is_initialized():
        dist.broadcast_object_list(value, src=0)
    return value[0]


def _rank0_first(fn, cfg: dict):
    """``fn(cfg)`` on rank 0, then on the other ranks with
    ``render_files=false``: rank 0 alone renders the offline datasets."""
    if _rank0():
        out = fn(cfg)
    _barrier()
    if not _rank0():
        out = fn({**cfg, "render_files": False})
    return out


class _Silent:
    """The logger of every rank but 0."""

    def log_hyperparams(self, *_):
        pass

    log_metrics = log_audio = close = log_hyperparams


def _logger(cfg: dict):
    return make_logger(cfg.get("logger", "csv"), cfg["logs_dir"]) if _rank0() else _Silent()


def _shard_state(task, state, mesh):
    """Rank 0's model on every rank; over ``tp > 1`` its parameters,
    gradients and AdamW state sharded by FSDP2 (a new optimizer over the
    sharded parameters takes the old one's state). -> the state."""
    task.mesh = mesh
    model = _model(task)
    replicate(model, mesh)
    if mesh_shape(mesh)["tp"] == 1:
        return state
    full = state.state_dict()
    net = model.module if isinstance(model, ModelWrapper) else model
    shard = shard_tcn_params if isinstance(net, TCN) else shard_params_channels
    half = getattr(task, "_half", False)
    shard(net, mesh, torch.bfloat16 if half else None)
    sharded = task.init_state()
    sharded.load_state_dict(full)
    return sharded


def _mean_over_ranks(metrics: dict) -> dict:
    """The metrics (0-d tensors or floats) as floats, averaged over every
    rank: after the trim each holds as many rows, so the mean of the
    ranks' means is the global batch's."""
    if not dist.is_initialized():
        return {k: float(v) for k, v in metrics.items()}
    keys = list(metrics)
    dev = "cpu" if dist.get_backend() == "gloo" else torch.cuda.current_device()
    v = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=dev)
    all_reduce_mean_([v])
    return dict(zip(keys, v.tolist()))


def build_datamodule(cfg: dict, device=None) -> EffectDatamodule:
    """The datamodule of ``cfg``, its renders on ``device``."""
    dm = cfg["datamodule"]
    device = device_of(cfg) if device is None else device
    common = dict(
        root=cfg.get("dataset_root"),
        sample_rate=cfg["sample_rate"],
        chunk_size=cfg["chunk_size"],
        effects_to_keep=cfg["effects_to_keep"] or [],
        effects_to_remove=cfg["effects_to_remove"] or [],
        num_kept_effects=cfg["num_kept_effects"],
        num_removed_effects=cfg["num_removed_effects"],
        shuffle_kept_effects=cfg["shuffle_kept_effects"],
        shuffle_removed_effects=cfg["shuffle_removed_effects"],
        effect_overrides=cfg.get("effects"),
        seed=cfg["seed"],
        synthetic=dm.get("synthetic", False),
        synthetic_rich=dm.get("synthetic_rich", False),
        synthetic_real_files=dm.get("synthetic_real_files", ()),
        device=device,
    )
    dstype = dm.get("dataset_type", "offline")
    if dstype == "inference":
        ds = InferenceDataset(root=cfg.get("dataset_root"),
                              sample_rate=cfg["sample_rate"])
        return EffectDatamodule(ds, ds, ds,
                                train_batch_size=dm["train_batch_size"],
                                test_batch_size=dm["test_batch_size"],
                                seed=cfg["seed"])
    offline = dict(render_files=cfg["render_files"], render_root=cfg["render_root"],
                   render_batch_size=dm.get("render_batch_size", 8), **common)
    if dstype == "dynamic":
        train = DynamicEffectDataset(
            total_chunks=dm.get("train_chunks", 8000), mode="train", **common)
    else:
        train = EffectDataset(total_chunks=dm.get("train_chunks", 8000),
                              mode="train", **offline)
    val = EffectDataset(total_chunks=dm.get("val_chunks", 1000), mode="val",
                        **offline)
    test = EffectDataset(total_chunks=dm.get("test_chunks", 1000), mode="test",
                         **offline)
    return EffectDatamodule(
        train, val, test,
        train_batch_size=dm["train_batch_size"],
        test_batch_size=dm["test_batch_size"],
        seed=cfg["seed"],
    )


def build_task(cfg: dict, device=None):
    """The task, its model on ``device`` with the weights torch draws after
    ``torch.manual_seed(cfg["seed"])``."""
    m = cfg["model"]
    if m is None:
        raise SystemExit("no model configured; pass +exp=NAME or model=...")
    device = device_of(cfg) if device is None else device
    torch.manual_seed(cfg["seed"])
    if m["task"] == "classifier":
        if m.get("name") == "embedding":
            net = make_embedding_classifier(
                m["network"]["kind"], num_classes=cfg["num_classes"],
                sample_rate=cfg["sample_rate"], device=device)
        else:
            net = make_cnn14(num_classes=cfg["num_classes"],
                             sample_rate=cfg["sample_rate"], device=device,
                             **m.get("network", {}))
        return ClassifierTask(
            net,
            lr=m.get("lr", 3e-4),
            lr_weight_decay=m.get("lr_weight_decay", 1e-3),
            use_mixup=m.get("mixup", False),
            sample_rate=cfg["sample_rate"],
            loss_type=m.get("loss_type", "bce"),
            label_smoothing=m.get("label_smoothing", 0.0),
            gradient_clip_val=cfg["trainer"].get("gradient_clip_val", 10.0),
            seed=cfg["seed"],
        )
    wrapper = make_model(m["name"], sample_rate=cfg["sample_rate"], device=device,
                         **m.get("network", {}))
    return RemovalTask(
        wrapper,
        lr=m.get("lr", 1e-4),
        lr_beta1=m.get("lr_beta1", 0.95),
        lr_beta2=m.get("lr_beta2", 0.999),
        lr_eps=m.get("lr_eps", 1e-6),
        lr_weight_decay=m.get("lr_weight_decay", 1e-3),
        max_steps=cfg["trainer"]["max_steps"],
        gradient_clip_val=cfg["trainer"].get("gradient_clip_val", 10.0),
        sample_rate=cfg["sample_rate"],
        accumulate_grad_batches=cfg["trainer"].get("accumulate_grad_batches", 1),
        precision=cfg["trainer"].get("precision", "32"),
    )


def _model(task):
    return task.network if isinstance(task, ClassifierTask) else task.wrapper


def _adapt_batch(task, batch):
    """(wet, dry, dry_labels, wet_labels) -> the task's (input, target) as
    tensors on the model's device (dynamic batches are there already)."""
    device = next(_model(task).parameters()).device
    wet, dry, dry_labels, wet_labels = (torch.as_tensor(t).to(device) for t in batch)
    if isinstance(task, ClassifierTask):
        return wet, wet_labels
    return wet, dry


def _mean_logs(rows: list[dict]) -> dict:
    if not rows:
        return {}
    keys = rows[0].keys()
    return {k: float(np.mean([float(r[k]) for r in rows])) for k in keys}


def evaluate(task, state, loader, prefix="valid", log_audio_to=None,
             sample_rate=48000, step=0):
    """Means of ``task.eval_step`` over ``loader``'s ``(rows, batch)``
    pairs, averaged over the ranks in a process group."""
    rows = []
    first = True
    for _, batch in loader:
        b = _adapt_batch(task, batch)
        rows.append(task.eval_step(state, b, prefix))
        if first and log_audio_to is not None and not isinstance(task, ClassifierTask):
            # AudioCallback parity (reference remfx/callbacks.py:45-83):
            # log [pred, 2 s silence, input, 2 s silence, target]
            x, y = b
            pred = task.wrapper.sample(x[:1])[0].cpu().numpy()
            silence = np.zeros((pred.shape[0], 2 * sample_rate), pred.dtype)
            # shortened outputs are tail-aligned (wrapper contract):
            # causal-crop input/target like the loss path
            xc = causal_crop(x[0], pred.shape[-1]).cpu().numpy()
            yc = causal_crop(y[0], pred.shape[-1]).cpu().numpy()
            log_audio_to.log_audio(f"{prefix}_pred_input_target",
                                   np.concatenate([pred, silence, xc, silence, yc], -1),
                                   sample_rate, step)
        first = False
    out = _mean_over_ranks(_mean_logs(rows))
    # epoch-style alias used by classifier checkpointing configs
    if f"{prefix}_avg_acc" in out:
        out[f"{prefix}_avg_acc_epoch"] = out[f"{prefix}_avg_acc"]
    return out


def _run_tag(cfg: dict) -> str:
    """Experiment identity stamped into last_meta.json so auto_resume
    never restores a same-architecture checkpoint from a DIFFERENT
    experiment that happens to share logs_dir."""
    m = cfg.get("model") or {}
    return "|".join([
        str(m.get("name")), str(m.get("task")),
        ",".join(sorted(cfg.get("effects_to_remove") or [])),
        ",".join(sorted(cfg.get("effects_to_keep") or [])),
    ])


def rank_fit(cfg: dict) -> dict:
    """One rank's ``fit`` (the function ``parallel.launch`` runs). -> the
    test metrics."""
    return fit(cfg)[1]


def rank_test(cfg: dict) -> dict:
    """One rank's ``test`` (the function ``parallel.launch`` runs)."""
    return test(cfg)


def fit(cfg: dict):
    """Train, validate each epoch, checkpoint, then test the best
    checkpoint. -> (state, test metrics); ``(None, rank 0's metrics)``
    from a call that starts ``trainer.devices`` ranks."""
    if _spawns(cfg):
        out = launch.spawn(rank_fit, _devices(cfg), cfg, device_type=_device_type(cfg))
        return None, out[0]
    mesh = build_mesh(cfg)
    device = device_of(cfg)
    datamodule = _rank0_first(partial(build_datamodule, device=device), cfg)
    task = build_task(cfg, device)
    state = task.init_state()
    # the JAX package draws its init batch here, which takes one
    # train_dataloader() call; take it too, so that the epochs (and with
    # them the shuffles and renders) are numbered as there
    datamodule.train_dataloader()
    start_step = 0
    start_epoch = 0
    resume_best = None
    prior = None
    if cfg.get("ckpt_path"):
        restore_from(cfg["ckpt_path"], state)
        log.info("restored checkpoint from %s", cfg["ckpt_path"])
    else:
        meta = None
        if cfg["trainer"].get("auto_resume"):
            # preemption recovery: resume from the newest "last" checkpoint
            # in this logs_dir, keeping the step counter and best-metric
            # watermark. Checked before warm_start, so that a preempted
            # warm-started fine-tune resumes its own progress
            prior = _from_rank0(lambda: find_latest_run(cfg["logs_dir"]))
            if prior is not None:
                meta = json.loads((prior / "last_meta.json").read_text())
                # another experiment's checkpoint in the same logs_dir
                # would restore without error and skip training
                tag = meta.get("run_tag")
                if tag is not None and tag != _run_tag(cfg):
                    log.warning(
                        "auto_resume: newest checkpoint %s is from a "
                        "different run (%s != %s); starting fresh",
                        prior, tag, _run_tag(cfg),
                    )
                    prior = None
        if prior is None and cfg.get("warm_start"):
            # params (+ BatchNorm statistics) from a donor, with a fresh
            # optimizer and schedule: unlike ckpt_path, the donor's update
            # count does not fast-forward the LR milestones
            checkpoint.warm_start(cfg["warm_start"], state)
            log.info("warm-started params from %s", cfg["warm_start"])
        if prior is not None:
            restore_from(str(prior / "last"), state)
            start_step = meta.get("step", 0)
            start_epoch = meta.get("epoch", 0)
            bm = prior / "best_meta.json"
            if bm.is_file():
                resume_best = json.loads(bm.read_text())
            log.info("auto-resumed from %s at step %d epoch %d",
                     prior, start_step, start_epoch)
            # continue the data sequence instead of replaying epochs
            # (+1: the call above already took one dataloader epoch)
            datamodule.set_epoch(start_epoch + 1)
    if mesh is not None:
        state = _shard_state(task, state, mesh)
        log.info("multi-device training: mesh %s", mesh_shape(mesh))

    logger = _logger(cfg)
    n_params = sum(p.numel() for p in _model(task).parameters())
    logger.log_hyperparams({**cfg, "model/params/total": n_params,
                            "model/params/trainable": n_params})
    log.info("model parameters: %s", f"{n_params:,}")
    mc = cfg["callbacks"]["model_checkpoint"]
    ckpts = CheckpointManager(
        Path(cfg["logs_dir"]) / "ckpts" / _from_rank0(lambda: time.strftime("%Y-%m-%d-%H-%M-%S")),
        monitor=mc.get("monitor", "valid_loss"),
        mode=mc.get("mode", "min"),
        writer=_rank0(),
    )
    if resume_best is not None and ckpts.monitor in resume_best:
        ckpts.best = float(resume_best[ckpts.monitor])

    max_steps = cfg["trainer"]["max_steps"]
    if max_steps is None or max_steps < 0:  # Lightning: -1 = unlimited
        max_steps = float("inf")
    max_epochs = cfg["trainer"].get("max_epochs", -1)
    log_every = cfg["trainer"].get("log_every_n_steps", 1)
    # Lightning counts OPTIMIZER steps against max_steps: with
    # accumulate_grad_batches=k each counted step consumes k micro-batches
    # (the update is applied on the k-th), keeping the LR milestones
    # (0.8/0.95 * max_steps) aligned
    accum = task.accumulate_grad_batches
    step = start_step
    # after a mid-cycle resume the restored state may hold accumulated
    # micro-batches; seed the micro counter from it so that `step`
    # advances exactly when the optimizer applies an update
    micro = state.mini_step % accum if accum > 1 else 0
    # the epoch resumes too, so max_epochs bounds TOTAL epochs across
    # preemptions (Lightning semantics)
    epoch = start_epoch
    t0 = time.time()
    prof = None
    rows_of = partial(batch_rows, mesh=mesh)
    eval_rows_of = partial(batch_rows, mesh=mesh, strict=False)
    if cfg.get("profile") and _rank0():
        # a torch.profiler trace of the training loop, for chrome://tracing
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    while step < max_steps and (max_epochs < 0 or epoch < max_epochs):
        for rows, batch in datamodule.train_dataloader(rows_of):
            state, metrics = task.train_step(state, _adapt_batch(task, batch), rows)
            heartbeat.beat()
            micro += 1
            if micro % accum:
                continue
            step += 1
            if step % log_every == 0:
                metrics = _mean_over_ranks(metrics)
                metrics["steps_per_sec"] = (step - start_step) / (time.time() - t0)
                logger.log_metrics(metrics, step)
            if step >= max_steps:
                break
        epoch += 1
        val_metrics = evaluate(
            task, state, datamodule.val_dataloader(eval_rows_of), "valid",
            log_audio_to=logger if cfg.get("log_audio") else None,
            sample_rate=cfg["sample_rate"], step=step,
        )
        logger.log_metrics(val_metrics, step)
        log.info("epoch %d step %d: %s", epoch, step,
                 {k: round(v, 4) for k, v in val_metrics.items()})
        ckpts.maybe_save_best(state, val_metrics, step)
        # the knob trades preemption-recovery granularity for the time a
        # save takes; the final epoch always saves, so a completed run is
        # resumable
        save_every = int(cfg["trainer"].get("save_last_every_n_epochs", 1) or 1)
        last_epoch = step >= max_steps or (max_epochs > 0 and epoch >= max_epochs)
        if epoch % save_every == 0 or last_epoch:
            ckpts.save_last(state, step, epoch, run_tag=_run_tag(cfg))

    if prof is not None:
        prof.stop()
        out = Path(cfg["logs_dir"]) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))

    # test with best (reference: trainer.test(ckpt_path="best"))
    if (ckpts.dir / "best").is_dir():
        ckpts.restore(state, "best")
    elif prior is not None and (prior / "best").is_dir():
        # the resumed run never improved on the prior best
        restore_from(str(prior / "best"), state)
    else:
        log.warning("no best checkpoint; testing final state")
    test_metrics = evaluate(task, state, datamodule.test_dataloader(eval_rows_of), "test")
    logger.log_metrics(test_metrics, step)
    log.info("test: %s", {k: round(v, 4) for k, v in test_metrics.items()})
    logger.close()
    return state, test_metrics


def test(cfg: dict):
    """Evaluate the test set, from ``ckpt_path`` when the config names one.
    -> the test metrics (rank 0's from a call that starts the ranks)."""
    if _spawns(cfg):
        return launch.spawn(rank_test, _devices(cfg), cfg, device_type=_device_type(cfg))[0]
    mesh = build_mesh(cfg)
    device = device_of(cfg)
    datamodule = _rank0_first(partial(build_datamodule, device=device), cfg)
    task = build_task(cfg, device)
    state = task.init_state()
    if cfg.get("ckpt_path"):
        restore_from(cfg["ckpt_path"], state)
    if mesh is not None:
        state = _shard_state(task, state, mesh)
    logger = _logger(cfg)
    metrics = evaluate(task, state,
                       datamodule.test_dataloader(partial(batch_rows, mesh=mesh, strict=False)),
                       "test")
    logger.log_metrics(metrics, 0)
    log.info("test: %s", {k: round(v, 4) for k, v in metrics.items()})
    logger.close()
    return metrics
