"""Device milliseconds a step of the kernels launched inside the port's
``groupnorm`` spans (``ops/group_norm.py:group_norm``): HDemucs's GroupNorms
with their activations in the training step's forward, on torch's path
(autograd records it). The backward's kernels, which autograd launches
from its own thread, are not in it."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "groupnorm")
