"""The whole batch's share of the card's dense bf16 peak, in percent: the
useful operations of a batch (``perfbench/flops.py``: Cnn14 on every row,
each removal model on the rows its label selects) over the host seconds
of an untraced batch and the peak of ``perfbench/peaks.json``."""


def read(run):
    return run.share_of_peak("bf16_flops")
