"""Device milliseconds a step of the kernels launched inside the port's
``lstm`` spans (``models/lstm.py:LSTM.forward``): the four BiLSTMs'
forward in DPTNet's training step. The backward's kernels, which autograd
launches from its own thread, are not in it."""

from perfbench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "lstm")
