"""The readers of the port's spans and counters: the spans in the CPU tiny
traced runs of both drivers, the readers' arithmetic on a made-up trace,
None where a trace has no device operation or no such span, and on the
card (``python -m pytest -m cuda perfbench/tests``) every new metric read
in both cells at their own sizes."""

import time

import pytest
import torch

from perfbench import harness
from perfbench import trace as tracing
from perfbench.drivers import chain, train_step
from perfbench.tests import tiny

torch.set_num_threads(4)
CHAIN_READERS = ("hdemucs_ms.chain", "dcunet_ms.chain", "removal_waste_pct.chain",
                 "lstm_idle_ms.chain")
TRAIN_READERS = ("forward_ms.train", "loss_ms.train", "metrics_ms.train",
                 "update_idle_ms.train")
# the tiny chain's 16 rows: buckets of 8 for 8, 2, 3 and 5 rows, the dense
# stage for the delay's 13
TINY_STAGES = {"chain.stage.distortion n=8 b=8": 8, "chain.stage.compressor n=2 b=8": 8,
               "chain.stage.reverb n=3 b=8": 8, "chain.stage.chorus n=5 b=8": 8,
               "chain.stage.delay n=13 b=dense": 16}


def _run(trace, iterations=1):
    return harness.Run(trace, iterations, 1.0, None, None)


@pytest.fixture(scope="module")
def chain_cell():
    spec, config = tiny.chain_inputs()
    cell = chain.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    return cell


def test_tiny_traced_chain_carries_the_ports_spans(chain_cell):
    trace = tracing.profile_iterations(chain_cell.iteration, 1, False)
    names = [name for _, _, _, name, cat in trace.host if cat == "user_annotation"]
    assert {"detect", "remove", "d2h", "chain.detect", "chain.counts", "model.demucs",
            "model.dcunet"} <= set(names)
    assert sorted(n for n in names if n.startswith("chain.stage.")) == sorted(TINY_STAGES)
    for name in CHAIN_READERS:  # no device operation on the CPU
        if name != "removal_waste_pct.chain":
            assert harness.read_metric(name, _run(trace)) is None, name


def test_tiny_traced_train_step_carries_the_ports_spans():
    spec, config = tiny.train_inputs()
    cell = train_step.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    trace = tracing.profile_iterations(cell.iteration, 1, False)
    names = {name for _, _, _, name, cat in trace.host if cat == "user_annotation"}
    assert {"h2d", "step", "train.step", "train.forward", "train.backward", "train.update",
            "train.clip", "train.metrics", "model.demucs", "loss",
            "Optimizer.step#AdamW.step"} <= names
    for name in TRAIN_READERS:
        assert harness.read_metric(name, _run(trace)) is None, name


def test_removal_waste_reads_the_unselected_share_of_the_rows_run(chain_cell, monkeypatch):
    from remfx_tpu_torch.chain.inference import ChainInference

    monkeypatch.setattr(ChainInference, "regroup_rows", 0)
    monkeypatch.setattr(ChainInference, "regroup_unselected", 0)
    assert harness.read_metric("removal_waste_pct.chain", _run(None)) is None
    for i in range(2):
        chain_cell.iteration(i)
    rows = sum(TINY_STAGES.values())
    unselected = sum(b - int(s.split(" n=")[1].split()[0]) for s, b in TINY_STAGES.items())
    assert (ChainInference.regroup_rows, ChainInference.regroup_unselected) == (2 * rows,
                                                                                 2 * unselected)
    value = harness.read_metric("removal_waste_pct.chain", _run(None))
    assert value == pytest.approx(100.0 * unselected / rows)


def _event(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid, "args": args}


def _made_up_trace(span_names):
    """Two steps of 1000 us. In each, a span from 100 to 500 us holds one
    launch of a 100 us kernel (200-300 us); a kernel launched outside it
    runs 600-700 us."""
    events = []
    for k, t in enumerate((0, 1000)):
        events += [_event(f"ProfilerStep#{k}", t, 1000),
                   _event("cudaLaunchKernel", t + 150, 5, "cuda_runtime", correlation=2 * k),
                   _event("k", t + 200, 100, "kernel", tid=7, correlation=2 * k),
                   _event("cudaLaunchKernel", t + 550, 5, "cuda_runtime", correlation=2 * k + 1),
                   _event("k", t + 600, 100, "kernel", tid=7, correlation=2 * k + 1)]
        events += [_event(name, t + 100, 400) for name in span_names]
    return tracing.Trace(events)


@pytest.mark.parametrize("reader,span,value", [
    ("hdemucs_ms.chain", "model.demucs", 0.1),
    ("dcunet_ms.chain", "model.dcunet", 0.1),
    ("forward_ms.train", "model.demucs", 0.1),
    ("loss_ms.train", "loss", 0.1),
    ("metrics_ms.train", "train.metrics", 0.1),
    ("lstm_idle_ms.chain", "lstm", 0.3),
    ("update_idle_ms.train", "train.update", 0.3),
])
def test_span_readers_on_a_made_up_trace(reader, span, value):
    """Device ms a step inside the span (0.1), or idle ms a step inside it
    (0.4 - 0.1); None where the trace has device operations but no such
    span, as a program without the spans gives."""
    assert harness.read_metric(reader, _run(_made_up_trace([span]), 2)) == pytest.approx(value)
    assert harness.read_metric(reader, _run(_made_up_trace(["remove"]), 2)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell,readers", [(tiny.CHAIN, CHAIN_READERS),
                                          (tiny.TRAIN, TRAIN_READERS)])
def test_every_new_metric_reads_on_the_card(cell, readers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = tiny.bench()
    spec, config = harness.cell_inputs(bench, cell)
    spec = dict(spec, untraced_iterations=2, trace_iterations=2)
    result = harness.run_cell(bench, cell, spec, config, tiny.SEED, 1.0, True, "cuda",
                              time.perf_counter(), torch.cuda.get_device_name(0))
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in readers:
        assert name in metrics and metrics[name]["value"] is not None, name
        assert metrics[name]["value"] >= 0.0, (name, metrics[name])
    if cell == tiny.CHAIN:
        removal = metrics["hdemucs_ms.chain"]["value"] + metrics["dcunet_ms.chain"]["value"]
        assert 0.9 * metrics["remove_ms.chain"]["value"] <= removal
        assert removal <= metrics["remove_ms.chain"]["value"]
        assert metrics["removal_waste_pct.chain"]["value"] == pytest.approx(100.0 * 27 / 104)
