"""Device milliseconds a batch of the kernels launched inside the port's
``model.demucs`` spans (``models/wrappers.py:ModelWrapper.forward``): the
distortion and compressor stages' HDemucs, without regroup's gathers,
scatters and crops around them."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "model.demucs")
