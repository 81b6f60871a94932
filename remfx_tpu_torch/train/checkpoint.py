"""Checkpoints of training runs, torch-native.

Counterpart of ``remfx_tpu/train/checkpoint.py`` (Lightning
ModelCheckpoint, reference cfg/config.yaml:31-40): monitor a metric, keep
top-1 ("best") and always save "last"; resume through an explicit path
or, with ``auto_resume``, from the newest run in ``logs_dir``. The layout
is the JAX package's:

    {logs_dir}/ckpts/{time stamp}/
        best/  last/  best_meta.json  last_meta.json (step, epoch, run_tag)

where ``best`` and ``last`` are directories; here each holds
``state.pt``, a ``torch.save`` of ``TrainState.state_dict()`` (the
model's, the optimizer's and the scheduler's state dicts and the
counters). A save replaces the live directory through ``name.tmp`` and
``name.old`` renames, so a crash never leaves ``name`` half written; the
``.tmp`` directory is itself renamed into place only once complete.

Reading the JAX package's orbax checkpoints waits for ROADMAP.md §A2; the
vendored ``ckpts/`` reach the port through ``compat/from_jax.py``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def _write(directory: Path, state) -> None:
    """``state.pt`` into ``directory``, which appears only when complete."""
    partial = directory.with_name(directory.name + ".partial")
    if partial.exists():
        shutil.rmtree(partial)
    partial.mkdir(parents=True)
    torch.save(state.state_dict(), partial / STATE_FILE)
    partial.rename(directory)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitor: str = "valid_loss", mode: str = "min"):
        self.dir = Path(ckpt_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best = None

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def _save(self, name: str, state):
        # write beside the live checkpoint, then swap by renames, so a
        # preemption mid-save never leaves `name` missing or half-written
        final = self.dir / name
        tmp = self.dir / f"{name}.tmp"
        old = self.dir / f"{name}.old"
        for p in (tmp, old):
            if p.exists():
                shutil.rmtree(p)
        _write(tmp, state)
        if final.exists():
            final.rename(old)
        tmp.rename(final)
        if old.exists():
            shutil.rmtree(old)

    def save_last(self, state, step: int, epoch: int = 0,
                  run_tag: str | None = None):
        self._save("last", state)
        (self.dir / "last_meta.json").write_text(
            json.dumps({"step": step, "epoch": epoch, "run_tag": run_tag})
        )

    def maybe_save_best(self, state, metrics: dict, step: int) -> bool:
        if self.monitor not in metrics:
            return False
        value = float(metrics[self.monitor])
        if self._is_better(value):
            self.best = value
            self._save("best", state)
            (self.dir / "best_meta.json").write_text(
                json.dumps({"step": step, self.monitor: value})
            )
            return True
        return False

    def restore(self, state, name: str = "best"):
        return restore_from(str(self.dir / name), state)


def find_latest_run(logs_dir: str):
    """Newest timestamped ckpt dir under ``logs_dir/ckpts`` that holds a
    completed "last" save, or None (preemption auto-resume)."""
    root = Path(logs_dir) / "ckpts"
    if not root.is_dir():
        return None
    runs = sorted(
        (d for d in root.iterdir() if (d / "last_meta.json").is_file()),
        key=lambda d: d.name,
        reverse=True,
    )
    for d in runs:
        if _repair_last(d):
            return d
    return None


def _repair_last(run_dir: Path) -> bool:
    """Finish an interrupted `last` swap (see CheckpointManager._save):
    prefer a completed `.tmp` (newer), fall back to `.old` (one save
    stale), and report whether a usable `last` exists."""
    last = run_dir / "last"
    if not last.is_dir():
        for cand in (run_dir / "last.tmp", run_dir / "last.old"):
            if cand.is_dir():
                cand.rename(last)
                break
    return last.is_dir()


def read_state(path: str, device=None) -> dict:
    """The raw state dict of the checkpoint directory ``path``."""
    return torch.load(Path(path) / STATE_FILE, map_location=device,
                      weights_only=True)


def restore_from(path: str, state):
    """Restore ``state`` (a ``TrainState``) in place from the checkpoint
    directory ``path``; returns it."""
    device = next(state.model.parameters()).device
    state.load_state_dict(read_state(path, device))
    return state


def warm_start(path: str, state):
    """Fine-tuning init from a port checkpoint: the donor's parameters and
    buffers (BatchNorm statistics) in ``state``'s dtypes, with the
    optimizer, the schedule and the counters left fresh."""
    donor = read_state(path, next(state.model.parameters()).device)["model"]
    own = state.model.state_dict()
    state.model.load_state_dict(
        {k: v.to(own[k].dtype) for k, v in donor.items()}, strict=True)
    return state
