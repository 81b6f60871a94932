"""The control of each cell comes out not correct: the reference in the
program's place in the precision below the configuration's. On the CPU the
chain's fp8 control at the tiny size; on the card both cells at their own
sizes, one seed each (``python -m pytest -m cuda perfbench/tests``)."""

import pytest
import torch

from perfbench import control, harness
from perfbench.drivers import train_step
from perfbench.tests import tiny


def _limits(spec):
    return spec["limits"]


def _passes(numbers, limits):
    return all(numbers[name] <= limit for name, limit in limits.items())


def test_chain_fp8_control_is_not_correct_on_the_cpu():
    spec, config = tiny.chain_inputs()
    (row,) = control.chain_rows(spec, config, [tiny.SEED], 1, device="cpu")
    assert _passes(row["program"], _limits(spec))
    assert not _passes(row["fp8"], _limits(spec))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [tiny.CHAIN, tiny.TRAIN])
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, config = harness.cell_inputs(tiny.bench(), cell)
    rows = control.chain_rows if cell == tiny.CHAIN else control.train_rows
    (row,) = rows(spec, config, [tiny.SEED], 1)
    assert _passes(row["program"], _limits(spec))
    for name in set(row) - {"seed", "program"}:
        assert not _passes(row[name], _limits(spec)), name


def test_train_leaf_readings_on_the_cpu():
    """The readings behind the change comparison's rule on the reference's
    gradient: the change gap under each rule, the median leaf's gradient
    reads 1, and the fp32 reference's gradient of a leaf at or above the
    median lies close to the fp64 one."""
    spec, config = tiny.train_inputs()
    (row,) = control.train_rows(spec, config, [tiny.SEED], 0, device="cpu", leaves=1,
                                noughts=(train_step.NOUGHT, 0.0))
    assert _passes(row["program"], _limits(spec))
    by_rule = row["change_gap_by_nought"]
    assert by_rule[str(train_step.NOUGHT)]["program"] == row["program"]["change_gap"]
    assert set(by_rule) == {str(train_step.NOUGHT), "0.0"}
    leaves = row["leaves"]
    assert len(leaves) == len({n for n, *_ in leaves}) > 10
    ratios = sorted(r for _, r, _, _ in leaves)
    assert ratios[len(ratios) // 2] == pytest.approx(1.0, rel=0.5)
    assert all(gap < 1e-2 for _, r, gap, _ in leaves if r >= 1.0)
