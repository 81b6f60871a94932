"""Milliseconds a step in which the host is inside the port's
``train.update`` span (``train/tasks.py:_apply_gradients``: the clip,
AdamW, the schedule) and nothing runs on the device."""

from perfbench.metrics import _spans


def read(run):
    return _spans.idle_ms(run, "train.update")
