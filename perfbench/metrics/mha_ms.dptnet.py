"""Device milliseconds a step of the kernels launched inside the port's
``dptnet.mha`` spans (``models/dptnet.py:ImprovedTransformerLayer``): the
multi-head attention's forward in both kinds of layer. The backward's
kernels, which autograd launches from its own thread, are not in it."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "dptnet.mha")
