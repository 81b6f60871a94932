"""The traffic generator: pinned label counts, crops, the WAV reader."""

import numpy as np
import pytest
import torch

from perfbench import harness, traffic
from perfbench.tests import tiny

SEEDS = [0, 1, 2**31 - 1, 2**31 + 11, 2**32 + 5]


def _chain():
    return harness.cell_inputs(tiny.bench(), tiny.CHAIN)


@pytest.mark.parametrize("seed", SEEDS)
def test_labels_give_the_pinned_counts_for_every_seed(seed):
    spec, config = _chain()
    gen = torch.Generator().manual_seed(seed)
    labels = traffic.pinned_labels(spec["label_counts"], config["label_columns"], 16,
                                   spec["rows"], gen)
    want = torch.tensor([float(spec["label_counts"][e]) for e in config["label_columns"]])
    assert labels.shape == (16, spec["rows"], len(config["label_columns"]))
    assert torch.equal(labels.sum(dim=1), want.expand(16, -1))
    assert len({tuple(b.flatten().tolist()) for b in labels}) == 16  # drawn afresh


def test_regroup_buckets_of_the_pinned_counts():
    from remfx_tpu_torch.utils.regroup import bucket_size

    spec, config = _chain()
    order = [s["label"] for s in config["stages"]]
    assert [bucket_size(spec["label_counts"][e], spec["rows"]) for e in order] == [24, 24, 16, 24, 16]


# bench.py's oracle labels, jax.random.uniform(jax.random.PRNGKey(7), (32, 5))
# < 0.5 (bench.py:134-135), drawn once with JAX on the CPU and copied here a
# row to a string, its columns in the label order (reverb, chorus, delay,
# distortion, compressor): the benchmark and its tests import no JAX.
BENCH_PY_ORACLE = (
    "00110", "01111", "10010", "11010", "01100", "10101", "01011", "01001",
    "10110", "01011", "11100", "01001", "10111", "01011", "00100", "00000",
    "00001", "01000", "01010", "11011", "00000", "01011", "10101", "00100",
    "11111", "00001", "00101", "01011", "00100", "01111", "00110", "11011",
)


def test_counts_are_bench_py_oracle_draw():
    spec, config = _chain()
    assert spec["rows"] == len(BENCH_PY_ORACLE)
    counts = [sum(row[c] == "1" for row in BENCH_PY_ORACLE) for c in range(5)]
    assert dict(zip(config["label_columns"], counts)) == spec["label_counts"]


def test_crops_are_seeded_rotations_with_distinct_offsets():
    spec, _ = harness.cell_inputs(tiny.bench(), tiny.TRAIN)
    args = (spec["pairs"], 3, 16, 4096, spec["gain_db"])
    x, y = traffic.crops(*args, torch.Generator().manual_seed(5), "cpu")
    again, _ = traffic.crops(*args, torch.Generator().manual_seed(5), "cpu")
    other, _ = traffic.crops(*args, torch.Generator().manual_seed(6), "cpu")
    assert x.shape == y.shape == (3, 16, 1, 4096)
    assert torch.equal(x, again) and not torch.equal(x, other)
    rows = x.reshape(48, -1)
    assert len({tuple(r[:64].tolist()) for r in rows}) == 48
    # the parts of an entry take one file, offset and gain: with a file as its
    # own partner the two parts are equal
    wet = spec["pairs"][0][0]
    a, b = traffic.crops([[wet, wet]], 2, 8, 4096, spec["gain_db"],
                         torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(a, b)


def test_read_wav_reads_the_demo_float_files():
    a = traffic.read_wav("perfbench/audio/example_target.wav")
    assert a.dtype == np.float32 and a.shape == (262144,) and 0.01 < a.std() < 1.0
