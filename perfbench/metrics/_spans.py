"""What the readers of the port's spans share (``remfx_tpu_torch/utils/spans.py``):
the device time launched inside a span, and the device's idle time while
the host is inside one.

A span is a ``user_annotation`` range of the trace. Where the trace holds
no device operation, or no span of the name (a program that records none),
a reader gets None, and the result line leaves its metric out.
"""

from __future__ import annotations

from perfbench import trace as tracing


def _spans(trace, prefix):
    """The merged host intervals, within the traced window, of the spans
    whose names start with ``prefix`` (a string or a tuple of them), on any
    thread."""
    return tracing._union([(max(s, trace.start), min(e, trace.end))
                           for _, s, e, name, cat in trace.host
                           if cat == "user_annotation" and name.startswith(prefix)
                           and min(e, trace.end) > max(s, trace.start)])


def _overlap(a, b) -> float:
    """Seconds that two lists of merged, sorted intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_ms(run, prefix):
    """Device milliseconds an iteration of the kernels, copies and fills
    launched inside spans whose names start with ``prefix``."""
    if not run.trace.device or not _spans(run.trace, prefix):
        return None
    return run.trace.device_ms_per(prefix, run.iterations)


def idle_ms(run, prefix):
    """Milliseconds an iteration in which the host is inside a span whose
    name starts with ``prefix`` and nothing runs on the device."""
    spans = _spans(run.trace, prefix)
    if not run.trace.device or not spans:
        return None
    inside = sum(e - s for s, e in spans)
    return 1e3 * (inside - _overlap(spans, run.trace._busy())) / run.iterations
