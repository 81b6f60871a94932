"""Fit/test loop — the Lightning-Trainer role, config-driven.

Counterpart of ``remfx_tpu/train/loop.py`` (the reference's
scripts/train.py:9-55): seed -> datamodule (rendering side-effect) ->
model/task -> fit with per-step logging, validation each epoch, best/last
checkpointing -> test with the best checkpoint.

The run's device comes from ``accelerator`` (``device_of``): ``"cpu"``
is the host; anything else is the card, and asking for it without one
raises. Training is one process on one device: ``trainer.devices > 1``
(the JAX package's mesh) waits for DDP (ROADMAP.md §A10).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from remfx_tpu_torch.data.datasets import (
    DynamicEffectDataset,
    EffectDatamodule,
    EffectDataset,
    InferenceDataset,
)
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.models.embedding_classifiers import make_embedding_classifier
from remfx_tpu_torch.train import checkpoint
from remfx_tpu_torch.train.checkpoint import CheckpointManager, find_latest_run, restore_from
from remfx_tpu_torch.train.loggers import make_logger
from remfx_tpu_torch.train.tasks import ClassifierTask, RemovalTask
from remfx_tpu_torch.utils import heartbeat
from remfx_tpu_torch.utils.crop import causal_crop
from remfx_tpu_torch.utils.device import resolve_device
from remfx_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def device_of(cfg: dict) -> torch.device:
    """``accelerator: cpu`` -> the host; anything else -> the card."""
    if int(cfg["trainer"].get("devices", 1) or 1) > 1:
        raise NotImplementedError(
            "trainer.devices > 1 needs DDP, which is not ported yet "
            "(ROADMAP.md §A10); train on one device")
    return resolve_device("cpu" if cfg.get("accelerator") == "cpu" else None)


def build_datamodule(cfg: dict, device=None) -> EffectDatamodule:
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
    rows = []
    first = True
    for batch in loader:
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
    out = _mean_logs(rows)
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


def fit(cfg: dict):
    """Train, validate each epoch, checkpoint, then test the best
    checkpoint. -> (state, test metrics)."""
    device = device_of(cfg)
    datamodule = build_datamodule(cfg, device)
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
            prior = find_latest_run(cfg["logs_dir"])
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

    logger = make_logger(cfg.get("logger", "csv"), cfg["logs_dir"])
    n_params = sum(p.numel() for p in _model(task).parameters())
    logger.log_hyperparams({**cfg, "model/params/total": n_params,
                            "model/params/trainable": n_params})
    log.info("model parameters: %s", f"{n_params:,}")
    mc = cfg["callbacks"]["model_checkpoint"]
    ckpts = CheckpointManager(
        Path(cfg["logs_dir"]) / "ckpts" / time.strftime("%Y-%m-%d-%H-%M-%S"),
        monitor=mc.get("monitor", "valid_loss"),
        mode=mc.get("mode", "min"),
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
    if cfg.get("profile"):
        # a torch.profiler trace of the training loop, for chrome://tracing
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    while step < max_steps and (max_epochs < 0 or epoch < max_epochs):
        for batch in datamodule.train_dataloader():
            state, metrics = task.train_step(state, _adapt_batch(task, batch))
            heartbeat.beat()
            micro += 1
            if micro % accum:
                continue
            step += 1
            if step % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["steps_per_sec"] = (step - start_step) / (time.time() - t0)
                logger.log_metrics(metrics, step)
            if step >= max_steps:
                break
        epoch += 1
        val_metrics = evaluate(
            task, state, datamodule.val_dataloader(), "valid",
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
    test_metrics = evaluate(task, state, datamodule.test_dataloader(), "test")
    logger.log_metrics(test_metrics, step)
    log.info("test: %s", {k: round(v, 4) for k, v in test_metrics.items()})
    logger.close()
    return state, test_metrics


def test(cfg: dict):
    """Evaluate the test set, from ``ckpt_path`` when the config names one.
    -> the test metrics."""
    device = device_of(cfg)
    datamodule = build_datamodule(cfg, device)
    task = build_task(cfg, device)
    state = task.init_state()
    if cfg.get("ckpt_path"):
        restore_from(cfg["ckpt_path"], state)
    logger = make_logger(cfg.get("logger", "csv"), cfg["logs_dir"])
    metrics = evaluate(task, state, datamodule.test_dataloader(), "test")
    logger.log_metrics(metrics, 0)
    log.info("test: %s", {k: round(v, 4) for k, v in metrics.items()})
    logger.close()
    return metrics
