"""Training of the port (``remfx_tpu/train``): tasks, checkpoints,
loggers and the fit/test loop. Entry point: ``python -m
remfx_tpu_torch.train +exp=NAME key=value ...``."""

from remfx_tpu_torch.train.loop import build_datamodule, build_task, evaluate, fit, test
from remfx_tpu_torch.train.tasks import ClassifierTask, RemovalTask, TrainState

__all__ = [
    "ClassifierTask",
    "RemovalTask",
    "TrainState",
    "build_datamodule",
    "build_task",
    "evaluate",
    "fit",
    "test",
]
