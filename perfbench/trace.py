"""The traced run: ``torch.profiler`` over a stated number of iterations,
reduced to device intervals, host ranges and the launches that tie them.

A kernel, copy or fill belongs to a host range (the benchmark's own
``record_function`` ranges, torch's ``Optimizer.step#...`` ranges, autograd's
``autograd::engine::evaluate_function: ...`` ranges) when the runtime call
that launched it ran inside that range on the same host thread. Busy time
is the union of the device intervals, so streams that overlap are not
counted twice; the window is the span of the profiler's step ranges.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("user_annotation", "cpu_op")
STEP = "ProfilerStep#"


def profile_iterations(run_iteration, iterations: int, cuda: bool) -> "Trace":
    """Run ``run_iteration(i)`` for i = 0 .. iterations under the profiler;
    the first is the profiler's warm-up and is not kept."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=iterations, repeat=1)) as prof:
        for i in range(iterations + 1):
            run_iteration(i)
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


def _union(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


class Trace:
    """Times in seconds, on the profiler's clock."""

    def __init__(self, events):
        spans = [e for e in events if e.get("ph") == "X"]
        steps = [e for e in spans if str(e.get("name", "")).startswith(STEP)]
        self.start = min(e["ts"] for e in steps) * 1e-6 if steps else 0.0
        self.end = max(e["ts"] + e["dur"] for e in steps) * 1e-6 if steps else 0.0
        self.main_tid = steps[0]["tid"] if steps else None
        launches = {e["args"]["correlation"]: e for e in spans
                    if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
        self.device = []  # (start, end, name, launch tid, launch time)
        for e in spans:
            if e.get("cat") not in DEVICE_CATEGORIES:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            tid, at = (launch["tid"], launch["ts"] * 1e-6) if launch else (None, None)
            self.device.append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"], tid, at))
        self.host = [(e["tid"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"], e["cat"])
                     for e in spans if e.get("cat") in HOST_CATEGORIES
                     and not str(e["name"]).startswith(STEP)]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def _busy(self):
        clipped = [(max(s, self.start), min(e, self.end)) for s, e, *_ in self.device]
        return _union([(s, e) for s, e in clipped if e > s])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy())

    def device_s_under(self, prefix: str) -> float:
        """Device seconds launched inside host ranges whose names start
        with ``prefix``."""
        ranges = defaultdict(list)
        for tid, s, e, name, _ in self.host:
            if name.startswith(prefix):
                ranges[tid].append((s, e))
        merged = {tid: _union(r) for tid, r in ranges.items()}
        return sum(e - s for s, e, _, tid, at in self.device
                   if tid in merged and _covered(merged[tid], at))

    def device_ms_per(self, prefix: str, iterations: int):
        """``device_s_under(prefix)`` in milliseconds an iteration; None
        where the trace holds no device operation."""
        if not self.device:
            return None
        return 1e3 * self.device_s_under(prefix) / iterations

    def device_ops(self, top: int = 10):
        total = defaultdict(float)
        for s, e, name, *_ in self.device:
            total[name] += e - s
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The longest gaps in the window with nothing on the device, each
        named by the innermost benchmark range and host operation on the
        main thread at its middle."""
        busy = self._busy()
        edges = [self.start] + [t for iv in busy for t in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return [[self._host_at((s + e) / 2), e - s] for s, e in gaps]

    def _host_at(self, t) -> str:
        """``<innermost user range>: <innermost operation>`` at ``t``."""
        def innermost(cat):
            inside = [(s, name) for tid, s, e, name, c in self.host
                      if tid == self.main_tid and c == cat and s <= t <= e]
            return max(inside)[1] if inside else "-"
        return f"{innermost('user_annotation')}: {innermost('cpu_op')}"
