"""CSV metrics logger + audio sample logging.

The port's copy of ``remfx_tpu/train/loggers.py``. Parity targets:
Lightning CSVLogger layout (logs_dir/<name>/version_N/
metrics.csv) and the reference ``AudioCallback`` (remfx/callbacks.py:
12-83): on the first validation batch, dump [pred, input, target] audio
for inspection (we write wavs instead of W&B objects; W&B itself is
optional/absent in this environment).
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path

import numpy as np

from remfx_tpu_torch.data.wav import write_wav


class CSVLogger:
    def __init__(self, logs_dir: str, name: str = "remfx_tpu"):
        base = Path(logs_dir) / name
        version = 0
        while (base / f"version_{version}").exists():
            version += 1
        self.dir = base / f"version_{version}"
        self.dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.dir / "metrics.csv", "w", newline="")
        self._writer = None
        self._fields = ["step", "time"]

    def log_hyperparams(self, cfg: dict):
        with open(self.dir / "hparams.json", "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    def log_metrics(self, metrics: dict, step: int):
        row = {"step": step, "time": f"{time.time():.3f}"}
        for k, v in metrics.items():
            row[k] = float(v)
        new_fields = [k for k in row if k not in self._fields]
        if new_fields or self._writer is None:
            self._fields += new_fields
            # rewrite header by reopening (simple, logs are small)
            self._file.close()
            path = self.dir / "metrics.csv"
            existing = []
            if path.exists() and path.stat().st_size:
                with open(path) as f:
                    existing = list(csv.DictReader(f))
            self._file = open(path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
            self._writer.writeheader()
            for r in existing:
                self._writer.writerow(r)
        self._writer.writerow(row)
        self._file.flush()

    def log_audio(self, name: str, audio, sample_rate: int, step: int):
        d = self.dir / "audio"
        d.mkdir(exist_ok=True)
        write_wav(d / f"{name}_step{step}.wav", np.asarray(audio), sample_rate)

    def close(self):
        self._file.close()


class WandbLogger:
    """W&B logger surface (reference cfg/logger/wandb.yaml +
    callbacks.py:85-109). Uses the real ``wandb`` package when it is
    importable and WANDB_PROJECT is set; otherwise degrades to an
    offline JSONL event stream + wav dumps with the same interface, so
    experiments keep their logging contract in air-gapped environments.
    """

    def __init__(self, logs_dir: str, name: str = "remfx_tpu"):
        import os

        self._csv = CSVLogger(logs_dir, name=name)  # always keep local copy
        self.dir = self._csv.dir
        self._events = open(self.dir / "events.jsonl", "a")
        self._wandb = None
        try:
            import wandb  # optional; absent in this environment

            self._wandb = wandb.init(
                project=os.environ.get("WANDB_PROJECT", name),
                entity=os.environ.get("WANDB_ENTITY"),
                dir=str(self.dir),
            )
        except Exception:
            self._wandb = None

    def _emit(self, kind: str, payload: dict):
        self._events.write(json.dumps({"kind": kind, **payload},
                                      default=str) + "\n")
        self._events.flush()

    def log_hyperparams(self, cfg: dict):
        self._csv.log_hyperparams(cfg)
        self._emit("hparams", {"cfg": cfg})
        if self._wandb is not None:
            self._wandb.config.update(cfg, allow_val_change=True)

    def log_metrics(self, metrics: dict, step: int):
        self._csv.log_metrics(metrics, step)
        self._emit("metrics", {"step": step,
                               **{k: float(v) for k, v in metrics.items()}})
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()},
                            step=step)

    def log_audio(self, name: str, audio, sample_rate: int, step: int):
        self._csv.log_audio(name, audio, sample_rate, step)
        self._emit("audio", {"name": name, "step": step,
                             "sample_rate": sample_rate})
        if self._wandb is not None:
            import wandb

            self._wandb.log(
                {name: wandb.Audio(np.asarray(audio).T,
                                   sample_rate=sample_rate)},
                step=step,
            )

    def close(self):
        self._csv.close()
        self._events.close()
        if self._wandb is not None:
            self._wandb.finish()


def make_logger(kind: str, logs_dir: str, name: str = "remfx_tpu"):
    """cfg["logger"] dispatch: "csv" (default) or "wandb"
    (reference cfg/logger/*.yaml surface)."""
    if kind == "wandb":
        return WandbLogger(logs_dir, name=name)
    return CSVLogger(logs_dir, name=name)
