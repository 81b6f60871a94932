"""The two cells of ``train.dptnet.b12`` and ``chain.all.b32`` at tiny sizes
on the CPU: DPTNet's training step against its reference, traced and not,
and the faults planted under it; its operation count against a hand
count; its readers on a made-up trace; and the all-on chain, whose every
stage runs dense."""

import copy
import time

import pytest
import torch

from perfbench import flops, harness
from perfbench import trace as tracing
from perfbench.drivers import chain, train_step_dptnet
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_cells import _gradient_altered, _half_batch
from perfbench.tests.test_perfbench_spans import _made_up_trace

torch.set_num_threads(4)
DPTNET, ALL = "train.dptnet.b12", "chain.all.b32"
TINY_DPTNET = {"kind": "dptnet", "init": "torch", "n_src": 1, "in_chan": 16, "out_chan": 16,
               "chunk_size": 10, "n_repeats": 1, "fb_name": "free", "kernel_size": 16,
               "n_filters": 16, "stride": 8, "num_bins": 1025}
READERS = {"intra_ms.dptnet": "dptnet.intra", "inter_ms.dptnet": "dptnet.inter",
           "mha_ms.dptnet": "dptnet.mha", "lstm_ms.dptnet": "lstm"}


def dptnet_inputs():
    spec, config = harness.cell_inputs(tiny.bench(), DPTNET)
    config = dict(config, model=dict(TINY_DPTNET))
    spec = dict(spec, rows=4, samples=4096, pool_batches=4, untraced_iterations=2,
                trace_iterations=2, reference_block_rows=2)
    return spec, config


def all_inputs():
    """chain.all.b32's workload file at the tiny chain's sizes: every label
    on in every one of 16 rows."""
    spec, config = harness.cell_inputs(tiny.bench(), ALL)
    assert set(spec["label_counts"].values()) == {spec["rows"]}
    config = copy.deepcopy(config)
    for stage in config["stages"]:
        if stage["label"] != "reverb":
            stage["model"] = dict(tiny.TINY_DEMUCS)
    spec = dict(spec, rows=16, samples=4096, pool_batches=2, label_batches=4, warmup_batches=1,
                label_counts={e: 16 for e in spec["label_counts"]}, untraced_iterations=2,
                trace_iterations=2, sample_from_first=2)
    return spec, config


@pytest.mark.parametrize("traced", [False, True])
def test_dptnet_cell_runs_correct(traced):
    spec, config = dptnet_inputs()
    # a window of some ten tiny steps (about 0.3 s each on four threads), so
    # that it holds the two checked steps after set-up's on a loaded host too
    result = harness.run_cell(tiny.bench(), DPTNET, spec, config, tiny.SEED, 3.0, traced, "cpu",
                              time.perf_counter(), "cpu")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(spec["limits"])
    if traced:  # no device operation on the CPU: every reader reads None
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"train_audio_s_per_s", "peak_gib", "setup_s"}


def _output_in_tf32(mp):
    """The model's output rounded to TF32's 10 bits of mantissa, its own
    gradient passed through: a forward whose products ran in TF32 is off by
    at least as much."""
    from remfx_tpu_torch.models import dptnet

    real = dptnet.DPTNet.forward

    def rounded(self, x):
        out = real(self, x)
        bits = (out.detach().view(torch.int32) + 0x1000) & ~0x1FFF
        return out + (bits.view(torch.float32) - out).detach()
    mp.setattr(dptnet.DPTNet, "forward", rounded)


@pytest.mark.parametrize("fault", [None, _half_batch, _gradient_altered, _output_in_tf32])
def test_dptnet_fault_is_not_correct(monkeypatch, fault):
    spec, config = dptnet_inputs()
    if fault is not None:
        fault(monkeypatch)
    cell = train_step_dptnet.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    cell.choose_samples(None)
    for i in range(cell.checked - cell.warmup):
        cell.iteration(i)
    monkeypatch.undo()
    cell.release()
    checks = {name: v <= limit for name, v, limit in cell.verify()}
    assert all(checks.values()) == (fault is None), checks
    if fault is _output_in_tf32:
        assert not checks["out_gap"]


def test_dptnet_reference_steps_in_fp64(monkeypatch):
    """The comparison's reference takes its checked steps in fp64 from the
    seeded fp32 weights and the pool's batches; asked for fp32 it takes
    them in fp32, and the two agree to fp32's rounding."""
    spec, config = dptnet_inputs()
    cell = train_step_dptnet.Cell(config, spec, tiny.SEED, "cpu")
    cell.pool = tuple(torch.randn(spec["pool_batches"], spec["rows"], 1, spec["samples"],
                                  generator=torch.Generator().manual_seed(i)) * 0.1
                      for i in (1, 2))
    seen, steps = [], train_step_dptnet.train_steps

    def spy(model, batches, optimizer, clip, rows):
        seen.append({t.dtype for t in [*model.parameters(), *batches[0]]})
        return steps(model, batches, optimizer, clip, rows)

    monkeypatch.setattr(train_step_dptnet, "train_steps", spy)
    wide, narrow = cell.reference(), cell.reference(torch.float32)
    assert seen == [{torch.float64}, {torch.float32}]
    assert wide[0] != narrow[0]
    assert max(abs(a - b) / b for a, b in zip(wide[0], narrow[0])) < 1e-5


def test_dptnet_program_loads_the_references_weights_both_ways():
    from remfx_tpu_torch.models import make_model

    spec, config = dptnet_inputs()
    cell = train_step_dptnet.Cell(config, spec, tiny.SEED, "cpu")
    reference = cell._reference_model()
    kw = {k: v for k, v in TINY_DPTNET.items() if k not in ("kind", "init")}
    program = make_model("dptnet", device="cpu", **kw).module
    program.load_state_dict(reference.state_dict(), strict=True)
    reference.load_state_dict(program.state_dict(), strict=True)
    again = cell._reference_model().state_dict()
    assert all(torch.equal(again[k], v) for k, v in reference.state_dict().items())
    other = train_step_dptnet.Cell(config, spec, tiny.SEED + 1, "cpu")._reference_model()
    for name in ("masker.layers.0.0.mha.in_proj_weight", "encoder.filterbank._filters"):
        assert not torch.equal(other.state_dict()[name], again[name]), name


def test_dptnet_operations_against_a_hand_count():
    """Forward: the encoder, the attention's projections and products, the
    BiLSTMs' gates, the feed-forward linear, the head's 1x1 convolutions and
    the decoder, 2 operations a multiply-add. The step: three times the
    forward (each product's two gradients), but twice for the encoder,
    whose input needs no gradient, and for the linear layer after each
    BiLSTM, whose input is ``perfbench/flops.py``'s stand-in for the LSTM,
    which needs none either (the LSTM's own backward is counted from its
    sizes)."""
    b, t = 3, 4096
    c, k, s, chunk, hid = 16, 16, 8, 10, 256
    frames = (t - k) // s + 1
    n_chunks = (frames + chunk) // (chunk // 2) + 1
    positions = b * n_chunks * chunk
    after_lstm = 2 * positions * 2 * hid * c  # the linear after the BiLSTM
    layer = (2 * positions * c * 4 * c  # q, k, v and out projections
             + 2 * 2 * 4 * hid * (c + hid) * positions  # two directions' gates
             + after_lstm)
    intra_products = 2 * 2 * positions * chunk * c  # scores and weighted sum, length chunk
    inter_products = 2 * 2 * positions * n_chunks * c  # length n_chunks
    encoder = 2 * b * c * k * frames
    forward = (encoder + 2 * layer + intra_products + inter_products
               + 2 * b * c * c * n_chunks * chunk  # first_out's 1x1 Conv2d
               + 2 * 2 * b * c * c * frames  # net_out, net_gate
               + 2 * b * c * k * frames)  # the decoder
    entry = dict(TINY_DPTNET, n_repeats=1)
    with torch.device("meta"):
        model = train_step_dptnet.build(entry)
    x = torch.empty(b, 1, t, device="meta")
    with torch.no_grad():
        assert flops._count(model, lambda: model(x), passes=1) == forward
    spec, config = dptnet_inputs()
    cell = train_step_dptnet.Cell(dict(config, model=entry), dict(spec, rows=b, samples=t),
                                  tiny.SEED, "cpu")
    assert cell.flops_per_iteration() == 3 * forward - encoder - 2 * after_lstm


def _run(trace, untraced_s=1.0, cell=None, peaks=None):
    return harness.Run(trace, 2, untraced_s, cell, peaks)


@pytest.mark.parametrize("reader,span", sorted(READERS.items()))
def test_dptnet_span_readers_on_a_made_up_trace(reader, span):
    """Device ms a step inside the span (0.1); None without the span, as a
    program that records none gives, or without a device operation."""
    assert harness.read_metric(reader, _run(_made_up_trace([span]))) == pytest.approx(0.1)
    assert harness.read_metric(reader, _run(_made_up_trace(["remove"]))) is None
    assert harness.read_metric(reader, _run(tracing.Trace([]))) is None


def test_dptnet_cell_reads_the_shared_step_metrics_and_its_own_spans():
    """The training step's metrics (``*.train``: the backward, AdamW, the
    loss, the step's metrics, the update's idle host, the forward, the idle
    share and the share of the peak) list the DPTNet cell beside HDemucs's;
    of its own only the four span readers; GroupNorm's is HDemucs's alone."""
    names = {m["name"] for m in harness.per_layer(tiny.bench(), DPTNET)}
    assert names == {"backward_ms.train", "optimizer_ms.train", "loss_ms.train",
                     "metrics_ms.train", "update_idle_ms.train", "forward_ms.train",
                     "idle_pct.train", "mfu.train"} | set(READERS)
    train = {m["name"] for m in harness.per_layer(tiny.bench(), tiny.TRAIN)}
    assert names - set(READERS) == train - {"groupnorm_ms.train"}


def test_dptnet_share_of_peak_counts_dptnets_operations():
    """``mfu.train`` on the DPTNet cell takes the cell's own count of a
    step's operations, the reference DPTNet's: 1e5 operations a step over
    a 1 ms step against a peak of 1e9 a second -> 10 %."""
    spec, config = dptnet_inputs()
    cell = train_step_dptnet.Cell(config, spec, tiny.SEED, "cpu")
    count = cell.flops_per_iteration()
    trace = _made_up_trace(["autograd::engine::evaluate_function: MmBackward0"])
    run = _run(trace, untraced_s=1e-3, cell=cell, peaks={"fp32_flops": count * 1e4})
    assert harness.read_metric("mfu.train", run) == pytest.approx(10.0)
    assert harness.read_metric("backward_ms.train", run) == pytest.approx(0.1)
    assert harness.read_metric("idle_pct.train", run) == pytest.approx(80.0)


def test_all_on_chain_runs_every_stage_dense_and_correct():
    spec, config = all_inputs()
    cell = chain.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    trace = tracing.profile_iterations(cell.iteration, 1, False)
    stages = [name for _, _, _, name, cat in trace.host
              if cat == "user_annotation" and name.startswith("chain.stage.")]
    assert sorted(stages) == sorted(f"chain.stage.{e} n=16 b=dense"
                                    for e in config["label_columns"])
    result = harness.run_cell(tiny.bench(), ALL, spec, config, tiny.SEED, 0.5, False, "cpu",
                              time.perf_counter(), "cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"chain_audio_s_per_s", "chain_batch_ms_p90", "peak_gib",
                                      "setup_s"}
