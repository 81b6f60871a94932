"""Device milliseconds a step of the kernels launched inside the port's
``model.*`` spans (``models/wrappers.py:ModelWrapper.forward``): HDemucs'
forward pass in ``RemovalTask.train_step``, without the loss."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "model.")
