"""The port's spans and counters (``remfx_tpu_torch/utils/spans.py``).

Under ``torch.profiler`` on the CPU: a five-slot regroup chain (two small
HDemucs with an LSTM, three Mini-DCUNet-6, on 16 rows so that it has
sub-batches, a dense stage and a skipped one) records the counts readback
and one span per stage with its ``n`` and bucket, each model inside its
stage and the LSTM inside the HDemucs; a training step records its
phases in order. With no profiler, no ``record_function`` is entered and
the outputs are bit for bit those of a traced call. The regroup counters
move by the buckets and their unselected rows.
"""

import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.models import make_cnn14, make_dcunet, make_model
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.train.tasks import RemovalTask
from remfx_tpu_torch.utils import spans

torch.set_num_threads(2)
PKG = Path(__file__).resolve().parents[1] / "remfx_tpu_torch"
SR, B, T = 48000, 16, 4096
DEMUCS = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64, depth=3,
              norm_starts=1, dconv_lstm=2, dconv_attn=1)
KIND = {"distortion": "demucs", "compressor": "demucs", "reverb": "dcunet",
        "chorus": "dcunet", "delay": "dcunet"}
# 5, 8 and 3 rows: buckets of 8; 13 of 16 rows (over 3/4): the dense stage;
# 0 rows: skipped
COUNTS = {"distortion": 5, "compressor": 13, "reverb": 0, "chorus": 8, "delay": 3}
STAGES = ["chain.stage.distortion n=5 b=8", "chain.stage.compressor n=13 b=dense",
          "chain.stage.reverb n=0 b=skip", "chain.stage.chorus n=8 b=8",
          "chain.stage.delay n=3 b=8"]
# the ranges the benchmark and torch record themselves, which its readers match
READER_PREFIXES = ("detect", "remove", "d2h", "h2d", "step", "autograd::", "Optimizer.")


def _demucs(seed):
    torch.manual_seed(seed)
    return ModelWrapper(HDemucs(**DEMUCS), name="demucs").eval()


@pytest.fixture(scope="module")
def models():
    out = {}
    for seed, effect in enumerate(DEFAULT_ORDER):
        label = EFFECT_CLASS_NAMES[effect]
        if KIND[label] == "demucs":
            out[effect] = _demucs(seed)
        else:
            torch.manual_seed(seed)
            out[effect] = make_dcunet(architecture="Mini-DCUNet-6", stft_kernel_size=64,
                                      device="cpu")
    return out


def _labels(counts=COUNTS, rows=B):
    labels = torch.zeros(rows, len(ALL_EFFECTS))
    for effect, n in counts.items():
        j = ALL_EFFECTS.index(effect)
        labels[[(i * (2 * j + 3) + j) % rows for i in range(n)], j] = 1.0
        assert labels[:, j].sum() == n
    return labels


def _x(rows=B, seed=0):
    return 0.3 * torch.randn(rows, 1, T, generator=torch.Generator().manual_seed(seed))


def _traced(fn):
    """-> (fn(), [(name, start, end)] of the profiler's events, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()),
                    key=lambda e: (e[1], -e[2]))
    return out, events


def _named(events, pred):
    return [e for e in events if pred(e[0])]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_regroup_chain_records_its_counts_stages_models_and_lstm(models):
    chain = ChainInference(models, SR, dispatch="regroup")
    _, events = _traced(lambda: chain.run(_x(), _labels()))
    (counts,) = _named(events, lambda n: n == "chain.counts")
    stages = _named(events, lambda n: n.startswith("chain.stage."))
    assert [s[0] for s in stages] == STAGES
    assert counts[2] <= stages[0][1]
    model_spans = _named(events, lambda n: n.startswith("model."))
    lstms = _named(events, lambda n: n == "lstm")
    for stage, effect in zip(stages, (EFFECT_CLASS_NAMES[e] for e in DEFAULT_ORDER)):
        inside = [m[0] for m in model_spans if _inside(m, stage)]
        assert inside == ([] if COUNTS[effect] == 0 else [f"model.{KIND[effect]}"]), stage
        n_lstm = sum(_inside(m, stage) for m in lstms)
        assert (n_lstm > 0) == (KIND[effect] == "demucs" and COUNTS[effect] > 0), stage
    assert all(any(_inside(m, d) for d in model_spans if d[0] == "model.demucs")
               for m in lstms)


def test_masked_chain_names_each_stage_without_counts(models):
    chain = ChainInference(models, SR, dispatch="single")
    _, events = _traced(lambda: chain.run(_x(), _labels()))
    assert not _named(events, lambda n: n == "chain.counts")
    stages = _named(events, lambda n: n.startswith("chain.stage."))
    assert [s[0] for s in stages] == [f"chain.stage.{EFFECT_CLASS_NAMES[e]}"
                                      for e in DEFAULT_ORDER]
    model_spans = _named(events, lambda n: n.startswith("model."))
    for stage, effect in zip(stages, DEFAULT_ORDER):
        kind = KIND[EFFECT_CLASS_NAMES[effect]]
        assert [m[0] for m in model_spans if _inside(m, stage)] == [f"model.{kind}"]


def test_detect_is_a_span():
    chain = ChainInference({}, SR, classifier=make_cnn14(device="cpu"))
    labels, events = _traced(lambda: chain.detect(_x(rows=2)))
    assert labels.shape == (2, len(ALL_EFFECTS))
    assert len(_named(events, lambda n: n == "chain.detect")) == 1


@pytest.mark.parametrize("counts", [
    COUNTS,
    {"distortion": 16, "compressor": 1, "reverb": 9, "chorus": 0, "delay": 12},
])
def test_regroup_counters_move_by_buckets_and_unselected_rows(models, monkeypatch, counts):
    """Rows run: a stage's bucket, or B for the dense stage, none for a
    skipped one; unselected: bucket - n, or B - n. The masked modes count
    nothing."""
    from remfx_tpu_torch.utils.regroup import bucket_size

    monkeypatch.setattr(ChainInference, "regroup_rows", 0)
    monkeypatch.setattr(ChainInference, "regroup_unselected", 0)
    buckets = {e: (bucket_size(n, B) or B) for e, n in counts.items() if n}
    x, labels = _x(), _labels(counts)
    ChainInference(models, SR, dispatch="single").run(x, labels)
    assert (ChainInference.regroup_rows, ChainInference.regroup_unselected) == (0, 0)
    chain = ChainInference(models, SR, dispatch="regroup")
    for k in (1, 2):
        chain.run(x, labels)
        assert ChainInference.regroup_rows == k * sum(buckets.values())
        assert ChainInference.regroup_unselected == k * sum(b - counts[e]
                                                            for e, b in buckets.items())


def _task(precision="32"):
    torch.manual_seed(11)
    return RemovalTask(ModelWrapper(HDemucs(**DEMUCS), name="demucs"), max_steps=100,
                       precision=precision)


def _batch(rows=2):
    x = _x(rows, seed=1)
    return x, x + 0.1 * _x(rows, seed=2)


@pytest.mark.parametrize("precision", ["32", "bf16-mixed"])
def test_train_step_records_its_phases_in_order(precision):
    task = _task(precision)
    state = task.init_state()
    _, events = _traced(lambda: task.train_step(state, _batch()))
    phases = _named(events, lambda n: n in ("train.forward", "train.backward", "train.update",
                                            "train.metrics"))
    assert [p[0] for p in phases] == ["train.forward", "train.backward", "train.update",
                                      "train.metrics"]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    (step,) = _named(events, lambda n: n == "train.step")
    assert all(_inside(p, step) for p in phases)
    forward, _, update, _ = phases
    assert [e[0] for e in events if _inside(e, forward) and e[0] in ("model.demucs", "loss")] \
        == ["model.demucs", "loss"]
    assert any(e[0] == "lstm" and _inside(e, forward) for e in events)
    inside_update = [e[0] for e in events if _inside(e, update)]
    assert "train.clip" in inside_update
    assert "Optimizer.step#AdamW.step" in inside_update
    assert inside_update.index("train.clip") < inside_update.index("Optimizer.step#AdamW.step")


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) entered with no profiler on")


def test_no_profiler_enters_no_record_function_and_changes_nothing(models, monkeypatch):
    x, labels = _x(), _labels()
    regroup = ChainInference(models, SR, dispatch="regroup")
    single = ChainInference(models, SR, dispatch="single")
    task_a, task_b = _task(), _task()
    batch = _batch()

    def everything(task):
        state = task.init_state()
        _, metrics = task.train_step(state, batch)
        return ([regroup.run(x, labels)[0], single.run(x, labels)[0]]
                + [metrics[k] for k in sorted(metrics)]
                + [p.detach().clone() for p in task.wrapper.parameters()])

    traced, events = _traced(lambda: everything(task_a))
    assert _named(events, lambda n: n.startswith("chain.stage."))
    monkeypatch.setattr(spans, "record_function", _refuse)
    assert spans.span("chain.counts") is spans.span("train.update")
    plain = everything(task_b)
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def _span_names():
    """(file, the literal start of each ``span(...)`` name) in the port."""
    for path in sorted(PKG.rglob("*.py")):
        if "from remfx_tpu_torch.utils.spans import span" not in path.read_text():
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "span":
                arg = node.args[0]
                if isinstance(arg, ast.JoinedStr):
                    arg = arg.values[0]
                assert isinstance(arg, ast.Constant), (path, ast.dump(node))
                yield path.name, arg.value


def test_span_names_are_listed_and_clear_of_the_readers_prefixes():
    names = list(_span_names())
    assert {n for _, n in names} >= {"chain.detect", "chain.counts", "chain.stage.", "model.",
                                     "loss", "lstm", "train.step", "train.forward",
                                     "train.backward",
                                     "train.update", "train.clip", "train.metrics"}
    for where, name in names:
        assert not name.startswith(READER_PREFIXES), (where, name)
        assert f"``{name}" in spans.__doc__, (where, name)


def _dptnet_task():
    torch.manual_seed(13)
    wrapper = make_model("dptnet", device="cpu", in_chan=16, out_chan=16, n_filters=16,
                         chunk_size=10, n_repeats=1)
    return RemovalTask(wrapper, max_steps=100)


def test_dptnet_train_step_records_its_layers_and_changes_nothing():
    """``dptnet.intra`` and ``dptnet.inter`` each hold a ``dptnet.mha`` and an
    ``lstm``, all inside ``model.dptnet``; the traced step's outputs and
    parameters are bit for bit an untraced step's."""
    batch = _batch()

    def step(task):
        state = task.init_state()
        _, metrics = task.train_step(state, batch)
        return ([metrics[k] for k in sorted(metrics)]
                + [p.detach().clone() for p in task.wrapper.parameters()])

    traced, events = _traced(lambda: step(_dptnet_task()))
    (model,) = _named(events, lambda n: n == "model.dptnet")
    layers = _named(events, lambda n: n in ("dptnet.intra", "dptnet.inter"))
    assert [e[0] for e in layers] == ["dptnet.intra", "dptnet.inter"]
    mhas = _named(events, lambda n: n == "dptnet.mha")
    lstms = _named(events, lambda n: n == "lstm")
    assert len(mhas) == len(lstms) == 2
    for layer, mha, lstm in zip(layers, mhas, lstms):
        assert _inside(layer, model) and _inside(mha, layer) and _inside(lstm, layer)
        assert mha[2] <= lstm[1]
    plain = step(_dptnet_task())
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
