"""Device milliseconds a batch of the kernels launched inside the port's
``groupnorm`` spans (``ops/group_norm.py:group_norm``): HDemucs's GroupNorms
with the activations they take, in both HDemucs stages of the chain."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "groupnorm")
