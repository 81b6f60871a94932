"""Both drivers end to end at tiny sizes on the CPU, against the reference,
and each fault that a cell can have planted under its timed path."""

import pytest
import torch

from perfbench.drivers import chain, train_step
from perfbench.tests import tiny

torch.set_num_threads(4)


@pytest.mark.parametrize("cell", [tiny.CHAIN, tiny.TRAIN])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct(cell, traced):
    result = tiny.run(cell, traced)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(tiny.chain_inputs()[0]["limits"] if cell == tiny.CHAIN
                                        else tiny.train_inputs()[0]["limits"])
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) >= {"peak_gib", "setup_s"}
        assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.fixture(scope="module")
def chain_cell():
    spec, config = tiny.chain_inputs()
    cell = chain.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    return cell


def _chain_verdict(cell, monkeypatch, patch):
    patch(monkeypatch)
    cell.kept = {}
    cell.sampled = {0, 1}
    for i in range(2):
        cell.iteration(i)
    monkeypatch.undo()
    return all(v <= limit for _, v, limit in cell.verify())


def _stage_unchanged(mp):
    """Every stage, dense or regrouped, returns its input."""
    mp.setattr("remfx_tpu_torch.chain.inference.masked_stage",
               lambda wrapper, idx: lambda y, labels: y)
    mp.setattr("remfx_tpu_torch.chain.inference.regrouped_stage",
               lambda wrapper, idx, n, bucket: lambda y, labels: y)


def _half_the_rows(mp):
    """Every stage removes the effect from the first half of its rows only."""
    from remfx_tpu_torch.chain import inference

    masked, regrouped = inference.masked_stage, inference.regrouped_stage

    def halved(labels, idx):
        kept = labels.clone()
        on = torch.nonzero(labels[:, idx] > 0.5)[:, 0]
        kept[on[(len(on) + 1) // 2:], idx] = 0.0
        return kept, (len(on) + 1) // 2

    mp.setattr(inference, "masked_stage", lambda wrapper, idx: lambda y, labels:
               masked(wrapper, idx)(y, halved(labels, idx)[0]))
    mp.setattr(inference, "regrouped_stage", lambda wrapper, idx, n, bucket: lambda y, labels:
               regrouped(wrapper, idx, halved(labels, idx)[1], bucket)(y, halved(labels, idx)[0]))


def _rows_swapped(mp):
    from remfx_tpu_torch.chain.inference import ChainInference

    real = ChainInference.run

    def swapped(self, x, labels=None, order=None):
        y, labels = real(self, x, labels, order)
        return y[[1, 0] + list(range(2, y.shape[0]))], labels
    mp.setattr(ChainInference, "run", swapped)


def _features_of_another_row(mp):
    """The classifier answers each row with its neighbour's features."""
    from remfx_tpu_torch.models.cnn14 import Cnn14

    real = Cnn14.embed
    mp.setattr(Cnn14, "embed", lambda self, x, generator=None: real(self, x, generator).roll(1, 0))


def test_chain_cell_is_correct_without_a_fault(chain_cell, monkeypatch):
    assert _chain_verdict(chain_cell, monkeypatch, lambda mp: None)


@pytest.mark.parametrize("fault", [_stage_unchanged, _half_the_rows, _rows_swapped,
                                   _features_of_another_row])
def test_chain_fault_is_not_correct(chain_cell, monkeypatch, fault):
    assert not _chain_verdict(chain_cell, monkeypatch, fault)


def _state_unchanged(mp):
    from remfx_tpu_torch.train.tasks import RemovalTask

    mp.setattr(RemovalTask, "_apply_gradients",
               lambda self, state: state.optimizer.zero_grad(set_to_none=True))


def _half_batch(mp):
    from remfx_tpu_torch.train.tasks import RemovalTask

    real = RemovalTask.train_step

    def half(self, state, batch, rows=None):
        n = batch[0].shape[0] // 2
        return real(self, state, (batch[0][:n], batch[1][:n]), rows)
    mp.setattr(RemovalTask, "train_step", half)


def _gradient_altered(mp):
    from remfx_tpu_torch.train import tasks

    real = tasks.clip_by_global_norm_

    def doubled(grads, max_norm):
        norm = real(grads, max_norm)
        for g in grads:
            g.mul_(2.0)
        return norm
    mp.setattr(tasks, "clip_by_global_norm_", doubled)


def _train_verdict(monkeypatch, fault, window_only=False, window_steps=None):
    """Set-up and the window's first steps with ``fault`` planted under
    both, or under the window's alone -> whether the cell comes out
    correct."""
    spec, config = tiny.train_inputs()
    if fault is not None and not window_only:
        fault(monkeypatch)
    cell = train_step.Cell(config, spec, tiny.SEED, "cpu")
    cell.setup()
    if fault is not None and window_only:
        fault(monkeypatch)
    cell.choose_samples(None)
    for i in range(cell.checked - cell.warmup if window_steps is None else window_steps):
        cell.iteration(i)
    monkeypatch.undo()
    cell.release()
    return all(v <= limit for _, v, limit in cell.verify())


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_batch, _gradient_altered])
def test_train_fault_is_not_correct(monkeypatch, fault):
    assert _train_verdict(monkeypatch, fault) == (fault is None)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _gradient_altered])
def test_train_fault_inside_the_window_only_is_not_correct(monkeypatch, fault):
    """The checked steps reach into the window: a step that goes wrong only
    once set-up's warm-up has ended is caught."""
    assert not _train_verdict(monkeypatch, fault, window_only=True)


def test_train_window_that_ends_before_the_checked_steps_is_not_correct(monkeypatch):
    assert not _train_verdict(monkeypatch, None, window_steps=1)
