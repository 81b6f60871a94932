"""The whole step's share of the card's fp32 peak without tensor cores
(TF32 is off), in percent: the useful operations of a step
(``perfbench/flops.py``: forward, loss and backward) over the host seconds
of an untraced step and the peak of ``perfbench/peaks.json``."""


def read(run):
    return run.share_of_peak("fp32_flops")
