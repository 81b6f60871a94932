"""Tiny cells for the CPU: the workload files and configurations of
``BENCHMARK.json`` with short crops, few rows and small removal models
(Cnn14 keeps its widths, which the program fixes; one Large-DCUNet-20
stage keeps its own), held to the workload files' own limits."""

from __future__ import annotations

import copy
import time

from perfbench import harness

CHAIN, TRAIN = "chain.detect.b32", "train.hdemucs.b16"
TINY_DEMUCS = {"kind": "demucs", "init": "torch", "sources": ["mixture"], "audio_channels": 1, "nfft": 64,
               "channels": 8, "depth": 3}
SEED = 2**31 + 11


def bench():
    return harness.load_json("BENCHMARK.json")


def chain_inputs():
    spec, config = harness.cell_inputs(bench(), CHAIN)
    config = copy.deepcopy(config)
    for stage in config["stages"]:
        if stage["label"] != "reverb":
            stage["model"] = dict(TINY_DEMUCS)
    # 16 rows: regroup's sub-batches of 8 for four stages, the dense masked
    # stage for the delay's 13 (over 3/4 of the rows)
    spec = dict(spec, rows=16, samples=4096, pool_batches=2, label_batches=4, warmup_batches=1,
                label_counts={"reverb": 3, "chorus": 5, "delay": 13, "distortion": 8,
                              "compressor": 2},
                untraced_iterations=2, trace_iterations=2, sample_from_first=2)
    return spec, config


def train_inputs():
    spec, config = harness.cell_inputs(bench(), TRAIN)
    config = dict(config, model=dict(TINY_DEMUCS))
    spec = dict(spec, rows=4, samples=8192, pool_batches=4, untraced_iterations=2,
                trace_iterations=2, reference_block_rows=2)
    return spec, config


def run(cell: str, traced: bool = False, seed: int = SEED, seconds: float = 0.5) -> dict:
    spec, config = chain_inputs() if cell == CHAIN else train_inputs()
    return harness.run_cell(bench(), cell, spec, config, seed, seconds, traced, "cpu",
                            time.perf_counter(), "cpu")
