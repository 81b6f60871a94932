"""One run of one cell: set-up, the measured or traced window, the metrics,
and the comparison with the reference that decides ``correct``.

Everything that belongs to one cell is found by name: the workload file
``perfbench/workloads/<traffic>.json`` (its driver, traffic, limits and the
statistic behind each end-to-end metric), the configuration file that
``BENCHMARK.json`` names, the window's module ``perfbench/drivers/<name>.py`` and
each per-layer metric's reader ``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from perfbench import trace as tracing
from perfbench.drivers import sync

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(ROOT / path) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_inputs(bench: dict, name: str):
    """-> (the cell's workload file, its configuration file)."""
    cell = cell_entry(bench, name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return load_json(HERE / "workloads" / f"{cell['traffic']}.json"), load_json(config["file"])


def end_to_end(bench: dict, cell_name: str):
    """The end-to-end metrics that list the cell, or list no cells."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str):
    """The per-layer metrics that list the cell; each lists its cells."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def percentile(values, q: float) -> float:
    """The nearest-rank percentile: an observed value."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


STATISTICS = {
    "work_per_s": lambda w: sum(r[2] for r in w["records"]) / w["window_s"],
    "latency_ms_p90": lambda w: 1e3 * percentile([r[1] - r[0] for r in w["records"]], 90),
    "peak_gib": lambda w: w["peak_bytes"] / 2**30,
    "setup_s": lambda w: w["setup_s"],
}


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def timed_window(cell, seconds: float, device) -> dict:
    """Iterations back to back until ``seconds`` have passed; every one is
    in the window, which ends with the last."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    start = end = time.perf_counter()
    i = 0
    while end - start < seconds:
        t = time.perf_counter()
        work = cell.iteration(i)
        end = time.perf_counter()
        records.append((t, end, work))
        i += 1
    return {"records": records, "window_s": end - start, "peak_bytes": _peak(device)}


def untraced_stretch(cell, iterations: int) -> float:
    """Host seconds an iteration over ``iterations`` back to back, the
    first call's start to the last one's end, with no profiler on."""
    start = time.perf_counter()
    for i in range(iterations):
        cell.iteration(i)
    return (time.perf_counter() - start) / iterations


class Run:
    """What a per-layer metric's reader reads: the trace, the iterations
    it holds, the host seconds an iteration of the same run takes with no
    profiler on, the cell's object and the card's peaks. The profiler's
    own host cost lengthens a traced iteration, so shares of time are
    taken over the untraced iteration."""

    def __init__(self, trace, iterations, untraced_s, cell, peaks):
        self.trace, self.iterations, self.untraced_s = trace, iterations, untraced_s
        self.cell, self.peaks = cell, peaks

    def idle_pct(self):
        """The share, in percent, of an untraced iteration in which no
        kernel, copy or fill runs on the device: the traced iterations'
        busy time (the union of their intervals) an iteration against the
        untraced iteration's time; None where nothing ran on the device."""
        if not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.iterations / self.untraced_s)

    def share_of_peak(self, rate: str):
        """The useful operations of an iteration over the untraced
        iteration's time and the card's peak ``rate``, in percent; None
        where the card has no entry in the table of peaks or nothing ran
        on it."""
        if self.peaks is None or not self.trace.device:
            return None
        return 100.0 * self.cell.flops_per_iteration() / (self.untraced_s * self.peaks[rate])


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def device_peaks(kind: str):
    return load_json(HERE / "peaks.json").get(kind)


def check_precision(config: dict, device):
    """Hold the run to the configuration's ``tf32``, where it states one:
    the CUDA matrix products' and cuDNN's TF32 flags as set-up left them."""
    if device.type != "cuda" or "tf32" not in config:
        return
    flags = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    wrong = {k: v for k, v in flags.items() if v != config["tf32"]}
    if wrong:
        raise SystemExit(f"the configuration states tf32 {config['tf32']}; set-up left {wrong}")


def run_cell(bench: dict, cell_name: str, spec: dict, config: dict, seed: int,
             seconds: float, traced: bool, device, t0: float, kind: str,
             after_setup=None) -> dict:
    """One run of the cell with its workload file ``spec`` and configuration
    ``config`` -> the result line's keys, the checks last. ``after_setup()``
    is called once set-up has ended, before the window opens."""
    device = torch.device(device)
    driver = importlib.import_module(f"perfbench.drivers.{spec['driver']}")
    cell = driver.Cell(config, spec, seed, device)
    cell.setup()
    sync(device)
    check_precision(config, device)
    if after_setup is not None:
        after_setup()
    setup_s = time.perf_counter() - t0
    if traced:
        iterations, untraced = spec["trace_iterations"], spec["untraced_iterations"]
        # the profiler's warm-up iteration is in the window too
        cell.choose_samples(untraced + iterations + 1)
        untraced_s = untraced_stretch(cell, untraced)
        trace = tracing.profile_iterations(lambda i: cell.iteration(untraced + i), iterations,
                                           device.type == "cuda")
        attempted = untraced + iterations + 1
    else:
        cell.choose_samples(None)
        window = timed_window(cell, seconds, device)
        window["setup_s"] = setup_s
        attempted = len(window["records"])
    memory_peak = _peak(device)
    cell.release()
    checks = cell.verify()

    metrics = {}
    if traced:
        run = Run(trace, iterations, untraced_s, cell, device_peaks(kind))
        for m in per_layer(bench, cell_name):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": STATISTICS[spec["statistics"][m["name"]]](window),
                                  "unit": m["unit"]}
    result = {
        "correct": all(math.isfinite(v) and v <= limit for _, v, limit in checks),
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": kind, "count": 1, "memory_peak_bytes": memory_peak},
    }
    if traced:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": [list(op) for op in trace.device_ops()],
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result
