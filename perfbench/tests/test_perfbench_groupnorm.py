"""The readers of the port's ``groupnorm`` span (``groupnorm_ms.chain``,
``groupnorm_ms.train``): device ms an iteration of the kernels launched
inside it on a made-up trace, None where the trace has device operations
but no such span (as the program before the span gives) or no device
operation (a CPU run); and the span in both drivers' tiny traced runs."""

import pytest
import torch

from perfbench import harness
from perfbench import trace as tracing
from perfbench.drivers import chain, train_step
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_spans import _made_up_trace, _run

torch.set_num_threads(4)
READERS = ("groupnorm_ms.chain", "groupnorm_ms.train")


@pytest.mark.parametrize("reader", READERS)
def test_reads_the_device_time_inside_the_span(reader):
    # two steps, each a 100 us kernel launched inside the span: 0.1 ms a step
    trace = _made_up_trace(["groupnorm"])
    assert harness.read_metric(reader, _run(trace, 2)) == pytest.approx(0.1)
    assert harness.read_metric(reader, _run(trace, 1)) == pytest.approx(0.2)


@pytest.mark.parametrize("reader", READERS)
def test_reads_none_without_the_span(reader):
    assert harness.read_metric(reader, _run(_made_up_trace(["model.demucs"]), 2)) is None
    assert harness.read_metric(reader, _run(_made_up_trace([]), 2)) is None


@pytest.mark.parametrize("driver,inputs", [(chain, tiny.chain_inputs),
                                           (train_step, tiny.train_inputs)])
def test_tiny_traced_runs_carry_the_span_inside_the_model(driver, inputs):
    spec, config = inputs()
    cell = driver.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    trace = tracing.profile_iterations(cell.iteration, 1, False)
    spans = [(s, e, name) for _, s, e, name, cat in trace.host if cat == "user_annotation"]
    norms = [(s, e) for s, e, name in spans if name == "groupnorm"]
    models = [(s, e) for s, e, name in spans if name == "model.demucs"]
    assert norms and all(any(ms <= s and e <= me for ms, me in models) for s, e in norms)
    for reader in READERS:  # no device operation on the CPU
        assert harness.read_metric(reader, _run(trace)) is None
