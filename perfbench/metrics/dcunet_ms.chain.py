"""Device milliseconds a batch of the kernels launched inside the port's
``model.dcunet`` spans (``models/wrappers.py:ModelWrapper.forward``): the
reverb, chorus and delay stages' Large-DCUNet-20, without regroup's
gathers, scatters and crops around them."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "model.dcunet")
