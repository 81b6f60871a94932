"""Device milliseconds a step of the kernels launched inside the port's
``train.metrics`` span (``train/tasks.py:RemovalTask.train_step``): the
step's SI-SDR and MR-STFT of output and input against the target."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "train.metrics")
