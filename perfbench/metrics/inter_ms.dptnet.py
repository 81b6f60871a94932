"""Device milliseconds a step of the kernels launched inside the port's
``dptnet.inter`` spans (``models/dptnet.py:DPTNet.forward``): the
inter-chunk layers' forward (sequences of a position's chunks) with their
reshapes. The backward's kernels, which autograd launches from its own
thread, are not in it."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "dptnet.inter")
