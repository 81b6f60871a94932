"""Device milliseconds a step of the kernels launched inside the port's
``loss`` span (``models/wrappers.py:loss_and_output``): the removal loss'
forward, MR-STFT + 100 L1 (``losses/``)."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "loss")
