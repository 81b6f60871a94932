"""The share of an untraced iteration, in percent, in which no kernel, copy
or fill runs on the device: the traced iterations' busy time (the union of
their intervals) an iteration against the same run's untraced iteration.
The traced window's own idle share, which carries the profiler's host
cost, is the result's ``busy_s`` and ``window_s``."""


def read(run):
    return run.idle_pct()
