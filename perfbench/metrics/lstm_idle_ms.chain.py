"""Milliseconds a batch in which the host is inside the port's ``lstm``
spans (``models/lstm.py:LSTM.forward``, HDemucs' BiLSTM) and nothing runs
on the device: the host work of cuDNN's bf16 LSTM call, which compacts
its weights every call, that the device waits on."""

from perfbench.metrics import _spans


def read(run):
    return _spans.idle_ms(run, "lstm")
