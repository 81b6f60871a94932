#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (remfx_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at full width, with seeded weights:
compressor render of 8 demo clips of 262144 samples at 48 kHz through the
hand-written envelope kernel -> Cnn14 detect (n_fft 2048, hop 512, 128
mels) -> the five removal slots in the chain's order: TCN (distortion;
10 blocks, width 64, receptive field 6139, so every later stage and the
output are 256006 samples long), HDemucs (compressor; channels 48, nfft
4096, depth 6, residual wrapper) and three Large-DCUNet-20 (reverb,
chorus, delay; stft kernel 512, "pad", identity_init), each at the
config of the repo's trained checkpoint of that slot.

Phases, each printing one JSON line with its elapsed seconds as it ends:
device, build (nvcc for sm_90a of every csrc/*.cu), kernels (each kernel
against its plain PyTorch version at the main path's shape, timed),
blstm_graph (the chain's HDemucs at 24 rows in bf16 with its BLSTMs eager
and replaying their CUDA graphs: enqueue and card times, bit equality,
the counters), render, synth (the data-synthesis path: EffectChainRenderer.render_batch
of the dataset's chain at the repo's default configuration on the 8 clips;
its labels, -20 LUFS on every output row, the same output again from the
same seed, card against CPU on 65536 samples, the C++ oracle's golden
outputs on the card, its wall time as audio seconds per second, each
effect's batched render time, and the envelope kernel's launches per
render_batch and per limiter call), build_slots, detect, remove (detected labels; oracle with all five
labels on, which use_all_effect_models must equal bit for bit; a mixed
pattern that switches every slot on in some rows and off in others),
dispatch (regroup and staged against single on 16 rows with an empty, a
sub-batch and a dense stage; all three bit for bit with every label on),
test_step (the chain's loss and metrics against the dry clips), and
cpu_vs_card (clip 0 on the CPU with the same weights: the classifier and
HDemucs at full width, the five-slot chain and test_step on its first
65536 samples), bf16, train and train_cls, trained, torch_import, umx,
dptnet and train_default (below). Then the kernel summary line, and the
result line last.

bf16 (``--only bf16`` runs the device and build phases and this one
alone): bench.py's chain (HDemucs in the distortion and compressor slots,
Large-DCUNet-20 in the other three, Cnn14; each at its trained
checkpoint's settings, seeded weights) on 32 x 262144 (the demo clips,
each four times), regroup, oracle labels drawn at p = 0.5, once with
every parameter, buffer and the input cast to bf16 and once in fp32 (TF32
off) from the same weights: the oracle row (detect timed beside the
removal) and the detect-driven row (labels that depend on the
classifier's output and equal the oracle's), each as audio seconds per
second with its peak memory (one warm-up, 3 timed passes), and a trace
of one oracle pass in each dtype (device busy share, top kernels); each
backbone's sample at 16 x 262144 in both dtypes. Checks: the output bf16
and finite, the detect-driven output equal to the oracle's bit for bit,
the bf16 chain within 0.2 x RMS of the fp32 chain (the bound
tests/test_torch_dtype.py holds a small width to) and above it with the
reverb's or the compressor's stage skipped, Cnn14's bf16 embedding within
0.06 x RMS of its fp32 embedding, the labels equal where fp32 Cnn14's
probabilities lie more than 0.05 from the threshold.

The kernels phase holds the envelope's split kernel (the main path's)
bit for bit to the serial kernel, on the demo batch and on an adversarial
one (a loud hit then digital zeros at 250 ms release, an all-zero row, a
row with cte_at = 0, and the corners of the attack and release ranges),
and reports both kernels' times, how many chunks the split kernel's
repair pass reran, and how many device kernels one call of it runs (from
a torch.profiler trace). The kernels line gives the envelope's launches
on each path: the render of the detect->remove path, the synthesis path
(the compressor; redraws and the limiter would add more), the training
runs, and none on the trained, stream, torch_import, umx and dptnet
paths, which render nothing.

Then the training path (the port's counterpart of the JAX package's
scripts/train.py), through fit / test of remfx_tpu_torch.train:

- train: compression_aug on the dynamic synthetic dataset, HDemucs (nfft
  4096, channels 48, mono) at 16 x 262144 a step, each batch rendered on
  the card (every row compressed: one envelope launch a step). fit takes
  4 steps, validates, saves best and last and tests best; test() from
  the best checkpoint gives the same metrics; an auto_resume run
  continues at step 4 for 2 more. Then 3 timed steps on fresh batches
  (render_ms, step_ms, the envelope's launches a step, peak memory, a
  torch.profiler count of the envelope's device kernels in one render +
  step, and a trace of one step's device time by kernel), 4 steps on one
  fixed batch whose loss must fall, one
  train_step at 65536 samples on the card and on the host CPU from the
  same weights, and on that fixed batch a bf16-mixed step beside an fp32
  step from the seed's weights (the first losses within 2^-8 relative,
  then 3 more steps of each timed, with their peaks).
- train_cls: 5-5_full_cls_dynamic (Cnn14 with SpecAugment, 32 x 262144,
  mixup off), two steps through fit; finite metrics and the envelope's
  launches.

Then the trained path (the port's counterpart of the JAX package's
scripts/demo_detect.py and scripts/remfx_detect.py), with no JAX:

- trained: the vendored checkpoints of the chain read by the port's
  orbax reader (compat/ocdbt.py, libzstd through ctypes), each timed:
  classifier_cnn14_r5, tcn_distortion_aug and dcunet_{reverb_aug_r4,
  chorus_aug_r5,delay_aug_r5} always (a missing one fails the phase),
  and demucs_compressor_aug_r5 where the checkout holds it (a full git
  checkout does; the copy that .chiprunignore trims to 256 MiB does not);
  demo_detect's chain built by build_chain on the card from exactly
  those directories (the compressor slot only with HDemucs'); detect ->
  remove of demos/synth_distortion_reverb.wav (262144 samples) against
  demos/synth_target.wav: the detected effects (distortion and reverb
  among them, equal to the CPU's), the probabilities (card against CPU),
  the removed effects, input and output SI-SDR, the detect and remove
  times and the peak allocation; the trained chain card against CPU on
  the first 65536 samples. Then stream_chain over four demo clips joined
  end to end (1,048,576 samples, five windows of 262144 overlapping by
  16384): audio seconds per wall second, the labels equal to detect on
  the loudest window, and one window equal to chain.remove bit for bit.

Then the last two removal backbones and the reference's torch files:

- torch_import: the trained chain's models written as .ckpt files in the
  reference's Lightning layout ("model.model." + the network's names, the
  classifier under "network."), imported by compat/torch_import.py, and
  demo_detect's chain built again by build_chain from those files and
  the vendored models' configs: its labels and removal of the demo clip
  equal the trained chain's bit for bit; the import seconds per file.
- umx: ckpts/umx_reverb_synth through the port's reader with the Wiener
  EM post-filter (niter=1) on 4 x 65536 synthetic chunks reverbed with
  the checkpoint's ranges: output SI-SDR above the input's, card against
  CPU on one row within 1e-5 of the peak (and the same with TF32 on, for
  comparison), sample_ms, peak memory.
- dptnet: DPTNet at the dptnet model config's full width (chunk 100, 2
  repeats, 4 heads, kernel 16, stride 8) with seeded weights: sample on
  the 8 demo clips x 262144 (32767 frames in 658 chunks), with the
  attention and softmax kernels one sample runs (torch.profiler), card
  against CPU on 16384 samples within 1e-5 of the peak (and with TF32
  on, for comparison), and 3 RemovalTask steps on 2 x 262144 whose loss
  must fall.
- train_default: +exp=default (UMX, 0-5 removed effects in the
  reference's order) through fit on the dynamic synthetic dataset at 16 x
  262144, 2 steps and one batch each of validation and test; the
  envelope's launches against the renders that drew the compressor;
  then 2 timed render + train steps.

Then the mixing channel and the evaluation surface:

- the kernels line also holds the phaser's hand-written kernels
  (csrc/phaser.cu; the JAX package renders it with a lax.scan, no TPU
  kernel) against phaser_plain, run on the host from the same
  coefficient: the serial kernel bit for bit at 8 x 2 x 16384 and 8 x 2 x
  262144, the split kernel (the default, three passes over chunks of
  time) within SPLIT_TOL of each row's peak at 8 x 2 x 262144 on the demo
  clips and on hard rows (the slowest poles, digital silence after a
  burst). Both are timed at 8 x 1 and 8 x 2 x 262144 by events over
  back-to-back calls (the line's "ms"), the split kernel also by replays
  of a CUDA graph ("graph_ms": the card's time without the host's three
  launches a call), with each pass's device time.
- the kernels line also holds HDemucs's GroupNorm kernel
  (csrc/group_norm.cu; no TPU kernel: the JAX package leaves GroupNorm to
  XLA) at the chain's largest time-branch norm (24 x 96 x 65536) and a
  frequency-branch one (12288 x 96 x 256) in bf16, each epilogue: against
  the plain composition in fp32 from the same inputs, two calls bit for
  bit, timed by events beside the plain composition in bf16 (torch's
  F.group_norm and activation) and the bytes bound; every norm of the main
  path's HDemucs (fp32, 8 x 256006, GroupNorm(1) and GroupNorm(4)) against
  fp64; its launches in one forward of the chain's HDemucs. Every phase
  line counts the kernel's launches in that phase
  (group_norm_launches), and the last kernels line gives them by path.
- and the DCUNet's eval epilogue (csrc/dcunet_epilogue.cu; no TPU kernel:
  the JAX package leaves the norm, leaky ReLU and skip concatenation to
  XLA) at the chain's largest Large-DCUNet-20 shape (24 x 257 x 1025
  pixels of 90 values packed in 96, bf16), an encoder's and a decoder's
  with its skip: against the
  plain version in fp32 from the same inputs, the skip and two calls bit
  for bit, timed by events beside the plain version in bf16 and the bytes
  bound; its launches in one inference of the chain's Large-DCUNet-20
  (19), which launches no cuDNN layout transpose or padding and no cat.
- channel: RandomAudioEffectsChannel on the demo clips as stereo, 8 x 2 x
  262144, with every stage forced on (the phaser's path: one phaser and
  three envelope launches), then at its default probabilities; every row
  at -32 LUFS; sox_reverb alone at max_room_scale 100 (n_fft 2^21),
  timed; one row card against CPU on 65536 samples.
- generate_dataset: python -m remfx_tpu_torch.cli.generate_dataset
  +exp=distortion, 4 chunks of 262144; the reference's files on disk.
- eval_matrix: python -m remfx_tpu_torch.cli.eval_matrix, oracle, detect
  and all at N = 0 and 1, 16 chunks of 262144, batch 8, one subprocess a
  cell, with the vendored classifier and slots of trained_dirs (the
  compressor slot seeded, and said so, only where HDemucs' directory is
  absent); finite metrics, oracle at N = 0 above 80 dB, detect above all
  at N = 1; a second sweep skips every cell. The table is printed.
- train_cls_pt: +exp=5-5_full_cls model=cls_panns_pt (the frozen Cnn14
  trunk at 32 kHz, a trainable head) through fit at 32 x 262144; the
  trunk unchanged bit for bit, the head moved, the checkpoint the head's;
  3 timed steps; one step card against CPU at 4 x 65536.

Then the multi-device slice, on every card there is (one under a plain
run; ``--only parallel`` runs the device and build phases and this one
alone, e.g. on four cards):

- parallel: compression_aug (HDemucs, 16 x 262144, fp32) fits 2 steps on
  an NCCL group of every card through parallel/launch.py, each rank
  rendering the one device's batch and keeping its rows, then 3 timed
  render + step rounds in each rank (render_ms, step_ms, peak memory,
  one envelope launch a step); the same fit in one process: the train
  loss per step within 1e-5 relative and the parameters after the steps
  within 0.2 lr. The tcn experiment's network (20 x 256, kernel 7) with
  remat on and off at 2 x 262144 fp32 (the gradients of a fixed ramp's
  product with the output, within 1e-6, and both peaks), and one
  bf16-mixed step with remat at 16 x 262144. PipelineChain of the seeded
  five-slot chain over the cards on 4 windows of the demo batch, each
  equal to ChainInference.run bit for bit, its wall time beside 4
  sequential run calls. Sequence-parallel inference of one long file (the
  stream part's four clips joined, 1 x 1 x 1048576) with the seeded
  five-slot chain: every backbone's time plan (parallel/sequence.py) run
  window by window as 4 ranks would hold it, on one card, against the
  whole file (the TCN's and the DCUNets' halo plans within 1e-5 x the
  output's RMS, the gather plans of HDemucs bit for bit); then shard_time
  over every card, sample_time_sharded of the TCN and a DCUNet and
  run_time_sharded with every label on and with detection against the
  whole file on one card, with the wall times, peaks and halos. Where
  there are two cards or more, a dp x tp (FSDP2) step of that TCN at 8 x
  131072 against one process.

Usage: python3 chip_smoke.py [--seed N] [--only kernels|blstm_graph|bf16|parallel|sequence]
(``--only sequence``: the sequence part of the parallel phase alone;
``--only kernels``: the kernels line alone; ``--only blstm_graph``: the
blstm_graph line alone.)
Needs one CUDA device: with none it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import csv
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.augment import EffectChainRenderer
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.chain.stream import _windows, stream_chain
from remfx_tpu_torch.cli import eval_matrix, generate_dataset
from remfx_tpu_torch.cli.demo_detect import detect_remove, trained_cfg
from remfx_tpu_torch.compat import ocdbt, torch_import
from remfx_tpu_torch.config.core import default_config, parse_cli
from remfx_tpu_torch.config.experiments import MODEL_CONFIGS
from remfx_tpu_torch.data.sources import synthetic_chunk
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.fx import RandomAudioEffectsChannel, compressor, make_effect
from remfx_tpu_torch.fx import phaser as phaser_fx
from remfx_tpu_torch.fx import sox_reverb
from remfx_tpu_torch.losses import si_sdr
from remfx_tpu_torch.models import (make_cnn14, make_dcunet, make_demucs, make_model,
                                    make_tcn)
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.embedding_classifiers import (make_embedding_classifier,
                                                       make_panns_embed_fn)
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.ops import _build
from remfx_tpu_torch.ops.envelope import (envelope, envelope_flags,
                                          envelope_plain, envelope_serial)
from remfx_tpu_torch.ops.dcunet_epilogue import (dcunet_epilogue, dcunet_epilogue_plain,
                                                  packed_width)
from remfx_tpu_torch.ops.group_norm import group_norm, group_norm_plain
from remfx_tpu_torch.ops.loudness import integrated_loudness, loudness_normalize
from remfx_tpu_torch.ops.phaser import CHUNK as PHASER_CHUNK
from remfx_tpu_torch.ops.phaser import SPLIT_TOL, phaser, phaser_plain, phaser_serial
from remfx_tpu_torch.parallel.sequence import GatherPlan, sample_windows, time_plan
from remfx_tpu_torch.train.checkpoint import (find_latest_run, load_trained_wrapper,
                                              read_state, restore_from, restore_tree)
from remfx_tpu_torch.train.loop import build_datamodule, build_task, fit, test
from remfx_tpu_torch.train.tasks import ClassifierTask, RemovalTask
from remfx_tpu_torch.utils.regroup import bucket_size

ROOT = Path(__file__).resolve().parent
SR = 48000
B, T = 8, 262144  # render batch (config/core.py render_batch_size), chunk
# widths of ckpts/classifier_cnn14_r5/hparams.json and
# ckpts/demucs_compressor_aug_r5/hparams.json
CNN14 = dict(n_fft=2048, hop_length=512, n_mels=128, model_sample_rate=SR)
DEMUCS = dict(sources=("mixture",), audio_channels=1, nfft=4096, channels=48,
              depth=6)
# r5 compressor ranges (hparams.json "effects.compressor"; attack and
# release keep the default ranges)
COMP_RANGES = {"min_threshold_db": -42.0, "max_threshold_db": -20.0,
               "min_ratio": 1.5, "max_ratio": 6.0,
               "min_attack_ms": 1.0, "max_attack_ms": 50.0,
               "min_release_ms": 10.0, "max_release_ms": 250.0}
# ckpts/tcn_distortion_aug/hparams.json (kernel 7, dilation growth 2 and
# stack 10 are make_tcn's defaults): receptive field 6139
TCN = dict(nblocks=10, channel_width=64)
T_OUT = T - 6139 + 1  # 256006: every stage after the TCN, and the output
# ckpts/dcunet_{reverb_aug_r4,chorus_aug_r5,delay_aug_r5}/hparams.json
DCUNET = dict(architecture="Large-DCUNet-20", stft_kernel_size=512,
              fix_length_mode="pad", identity_init=True, norm_type="bN")
SLOT = "RandomPedalboardCompressor"
# rows on per effect of the dispatch phase's 16: an empty stage (the
# TCN: crop only), sub-batches of 8 (5 and 8 rows) and dense stages
# (more than 0.75 x 16 rows, or a bucket of 16)
DISPATCH_COUNTS = {"distortion": 0, "compressor": 5, "reverb": 14,
                   "chorus": 8, "delay": 12}
CPU_T = 65536  # samples of clip 0 in the CPU run of the five-slot chain
# synth: the LUFS target of every output row, card against CPU on the
# first SYNTH_CPU_T samples of the clips, and the golden outputs of the C++
# oracle (tests/fixtures/golden_dsp.npz) at tests/test_golden_fixtures.py's
# absolute tolerances
LUFS_TOL = 0.01
SYNTH_CPU_T = 65536
SYNTH_CPU_TOL = 1e-4  # x peak: the FFT effects' tolerance against JAX
GOLDEN = ROOT / "tests" / "fixtures" / "golden_dsp.npz"
GOLDEN_TOL = {"distortion": 2e-6, "delay": 2e-4, "compressor": 1e-4,
              "limiter": 1e-4, "chorus": 2e-4, "reverb": 5e-4}
ENV_TOL = 2e-4  # x row peak: fp32 rounding through the 1/(1-cte) pole
CPU_TOL = 1e-3  # card vs CPU, TF32 off on both
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12
DEVICE = "cuda"


class Phases:
    def __init__(self):
        self.start = time.perf_counter()
        self.last = self.start
        self.group_norm = {}  # phase -> the GroupNorm kernel's launches in it
        self.dcunet_epilogue = {}  # phase -> the DCUNet epilogue's launches in it
        self._gn = group_norm.launches
        self._epi = dcunet_epilogue.launches

    def done(self, phase: str, /, **fields):
        now = time.perf_counter()
        launched = group_norm.launches - self._gn
        self._gn = group_norm.launches
        self.group_norm[phase] = self.group_norm.get(phase, 0) + launched
        epi = dcunet_epilogue.launches - self._epi
        self._epi = dcunet_epilogue.launches
        self.dcunet_epilogue[phase] = self.dcunet_epilogue.get(phase, 0) + epi
        line = {"phase": phase, "seconds": round(now - self.last, 3),
                "total_seconds": round(now - self.start, 3),
                "group_norm_launches": launched, "dcunet_epilogue_launches": epi, **fields}
        print(json.dumps(line), flush=True)
        self.last = now


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def demo_clips() -> np.ndarray:
    """(8, 262144) mono clips from demos/*.wav: each file wrapped to the
    chunk length; the 8th is the first, rotated by half a chunk."""
    clips = []
    for path in sorted((ROOT / "demos").glob("*.wav")):
        x, sr = read_wav(path)
        check(sr == SR, f"{path.name} is {sr} Hz")
        clips.append(np.pad(x[0, :T], (0, max(0, T - x.shape[1])), mode="wrap"))
    check(len(clips) >= B - 1, "demos/ holds at least 7 wavs")
    clips = clips[: B - 1] + [np.roll(clips[0], T // 2)]
    return np.stack(clips).astype(np.float32)


def time_kernel(fn, warmup: int = 3, rounds: int = 5, calls: int = 10) -> float:
    """Median over ``rounds`` of the ms a call takes, each round ``calls``
    back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def graph_ms(fn, rounds: int = 5, replays: int = 10) -> float:
    """Median ms of one call of ``fn`` replayed from a CUDA graph: the
    card's time for the call without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_kernel(graph.replay, rounds=rounds, calls=replays)


def load_kernel_modules(dev):
    """One launch of each hand kernel on a tiny input, before any profiler
    trace starts. CUDA loads a kernel at its first launch, and a trace has
    missed the phaser's kernel, first launched after the envelope's traces,
    in every try of a process, where the envelope's kernels, first launched
    before any trace, were seen."""
    x = torch.full((1, 4096), 0.5, device=dev)
    c = torch.full((1,), 0.5, device=dev)
    envelope(x, c, c)
    phaser(x[:, None, :].contiguous(), x, c, c)
    phaser_serial(x[:, None, :].contiguous(), x, c, c)
    w = torch.ones(4, device=dev)
    with torch.no_grad():
        group_norm(x.view(1, 4, 1024), 1, w, w, act="gelu")
        dcunet_epilogue(x.view(1, 2, 32, 64).contiguous(memory_format=torch.channels_last),
                        torch.ones(6, 1, device=dev))
    torch.cuda.synchronize()


def device_kernels(fn) -> list:
    """Names of the device kernels that one call of ``fn`` runs, in a
    torch.profiler trace of the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def adversarial_batch(clips: torch.Tensor):
    """(8, 262144) |x| and per-row coefficients that the bracket of the split
    kernel cannot close everywhere: a 0.1 s hit then digital zeros at 250 ms
    release, an all-zero row, cte_at = 0, then the ranges' corners."""
    xa = clips.abs().contiguous()
    xa[0, SR // 10:] = 0.0
    xa[1] = 0.0
    attack = torch.tensor([1.0, 10.0, 5e-4, 1.0, 1.0, 50.0, 50.0, 25.0])
    release = torch.tensor([250.0, 100.0, 250.0, 10.0, 250.0, 10.0, 250.0,
                            130.0])
    at = compressor.ballistics_cte(attack, SR).to(xa.device).contiguous()
    rl = compressor.ballistics_cte(release, SR).to(xa.device).contiguous()
    return xa, at, rl


def split_vs_serial(xa, at, rl) -> dict:
    """The split kernel against the serial kernel: bitwise, and timed."""
    got, unresolved = envelope_flags(xa, at, rl)
    serial = envelope_serial(xa, at, rl)
    equal = torch.equal(got, serial)
    check(equal, "split kernel equals the serial kernel bit for bit")
    return {"serial_equal": equal,
            "walked_chunks": int(unresolved.sum().item()),
            "chunks": unresolved.numel(),
            "kernel_ms": time_kernel(lambda: envelope(xa, at, rl)),
            "serial_ms": time_kernel(lambda: envelope_serial(xa, at, rl))}


def kernels_phase(clips: torch.Tensor, gen: torch.Generator) -> dict:
    """The envelope kernel against envelope_plain at the main path's shape,
    and against the serial kernel there and on the adversarial batch."""
    dev = clips.device
    xa = clips.abs().contiguous()
    p = compressor.sample_params(gen, B, COMP_RANGES, device=dev)
    at = compressor.ballistics_cte(p["attack_ms"], SR).contiguous()
    rl = compressor.ballistics_cte(p["release_ms"], SR).contiguous()
    got = envelope(xa, at, rl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = envelope_plain(xa, at, rl)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff = (got - want).abs()
    peak = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    max_rel = (diff / peak).max().item()
    check(bool(torch.isfinite(got).all()), "envelope finite")
    check(max_rel <= ENV_TOL, f"envelope max_rel_err {max_rel} <= {ENV_TOL}")
    demo = split_vs_serial(xa, at, rl)
    adversarial = split_vs_serial(*adversarial_batch(clips))
    kernels = device_kernels(lambda: envelope(xa, at, rl))
    check(len(kernels) >= 1, "the profiler saw the envelope's device kernels")
    rows, steps = xa.shape
    n_bytes = (2 * rows * steps + 2 * rows) * 4  # x in, env out, 2 coefs
    n_ops = 4 * rows * steps  # per step: sub, 2 FMAs (as 1 op each), compare
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return {
        "name": "envelope",
        "route": "cuda",
        "source": "remfx_tpu_torch/csrc/envelope.cu",
        "replaces": "remfx_tpu/ops/pallas_env.py:33",
        "shape": [rows, steps],
        "device_kernels_per_call": len(kernels),
        "device_kernels": kernels,
        "max_abs_err": diff.max().item(),
        "max_rel_err": max_rel,
        "ms": demo["kernel_ms"],
        "kernel_ms": demo["kernel_ms"],
        "serial_ms": demo["serial_ms"],
        "serial_equal": demo["serial_equal"] and adversarial["serial_equal"],
        "walked_chunks": demo["walked_chunks"],
        "chunks": demo["chunks"],
        "adversarial": adversarial,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


GN_SHAPES = {"time": (24, 96, 65536), "freq": (24 * 512, 96, 256)}
GN_ACTS = ("gelu", "glu", "glu+residual")
GN_RTOL, GN_ATOL = 2.0**-8, 1e-3  # bf16 against fp32: one rounding, sums reordered
GN_FP32_TOL = 1e-5  # fp32 against fp64, of 1 + |value|: fp32 sums of 10^5-10^7 elements


def group_norm_main_path(seed: int) -> dict:
    """Every norm of the main path's HDemucs (fp32, B rows of T_OUT
    samples, seeded weights: GroupNorm(1) in the DConvs, GroupNorm(4) from
    layer 4 on), each call of the kernel held to the plain composition in
    fp64 from the same inputs, with torch's fp32 composition's error beside
    it -> {"<shape>/g<groups>/<act>": errors}."""
    dev = torch.device(DEVICE)
    torch.manual_seed(seed)
    model = demucs_slot(dev).module
    cases = {}

    def hook(m, args, kwargs, out):
        x, res, scale = args[0], kwargs.get("residual"), kwargs.get("scale")
        act = m.act + ("+residual" if res is not None else "")
        f64 = [None if t is None else t.double() for t in (x, m.weight, m.bias, res, scale)]
        want = group_norm_plain(f64[0], m.num_groups, f64[1], f64[2], m.eps, m.act, *f64[3:])
        torch_fp32 = group_norm_plain(x, m.num_groups, m.weight, m.bias, m.eps, m.act, res,
                                      scale)
        key = f"{'x'.join(map(str, x.shape))}/g{m.num_groups}/{act}"
        err = ((out.double() - want).abs() / (1 + want.abs())).max().item()
        torch_err = ((torch_fp32.double() - want).abs() / (1 + want.abs())).max().item()
        prev = cases.get(key, {"err": 0.0, "torch_fp32_err": 0.0, "calls": 0})
        cases[key] = {"err": max(prev["err"], err),
                      "torch_fp32_err": max(prev["torch_fp32_err"], torch_err),
                      "calls": prev["calls"] + 1}

    hooks = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
             if type(m).__name__ == "GroupNormAct"]
    x = 0.1 * torch.randn(B, 1, T_OUT, generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    worst = max(c["err"] for c in cases.values())
    check(worst <= GN_FP32_TOL, f"group_norm in fp32 within {GN_FP32_TOL} of fp64 at the "
          f"main path's shapes: {worst}")
    check(any("/g4/" in k for k in cases) and any("/g1/" in k for k in cases),
          f"the main path has GroupNorm(1) and GroupNorm(4): {sorted(cases)}")
    return cases


# a Large-DCUNet-20 stage of the chain: 24 rows at 262144 samples, 257 x 1025
# pixels (the "pad" mode's frames), 45 complex channels packed as 90
EPI_SHAPE = (24, 257, 1025)
EPI_C = 45
DCUNET_LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "CatArrayBatchedCopy", "nhwcAddPadding")


def dcunet_epilogue_row(seed: int) -> dict:
    """The DCUNet's eval epilogue kernel at the chain's largest shape (bf16):
    an encoder's (the conv output, 24 x 257 x 1025 pixels of 90 values and
    6 zeros) and the last decoder's with its skip (the same, plus a skip of
    as many channels), each against the plain version in fp32 from the same
    inputs, the skip bit for bit, two calls bit for bit; "ms" by events
    over back-to-back calls, "plain_ms" the plain version in bf16 on the
    card; the bytes bound reads the conv output and the skip and writes the
    output once. Then one inference of a Large-DCUNet-20 at the chain's
    shape (bf16, 24 x 262144): the kernel's launches, and that no cuDNN
    layout transpose or channel padding and no cat ran."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, H, W = EPI_SHAPE
    coef = torch.randn(6, EPI_C, generator=g, device=dev)
    width = packed_width(2 * EPI_C)  # 90 values and 6 zeros a pixel

    def packed():
        x = torch.randn(B, H, W, width, generator=g, device=dev).to(torch.bfloat16)
        x[..., 2 * EPI_C:] = 0
        return x.permute(0, 3, 1, 2)

    x = packed()
    cases = {}
    for where, skip in (("encoder", None), ("decoder_skip", packed())):
        s2 = 0 if skip is None else 2 * EPI_C
        args = (x, coef, skip, s2)
        with torch.no_grad():
            got = dcunet_epilogue(*args)
            again = dcunet_epilogue(*args)
            want = dcunet_epilogue_plain(x.float(), coef,
                                         None if skip is None else skip.float(), s2)
            diff = (got.float() - want).abs()
            err = (diff - GN_RTOL * want.abs()).max().item()
        check(torch.equal(got, again), f"dcunet_epilogue repeats bit for bit ({where})")
        check(err <= 1e-6, f"dcunet_epilogue within one bf16 rounding of fp32 ({where}): {err}")
        if skip is not None:
            check(torch.equal(got[:, 2 * EPI_C:4 * EPI_C], skip[:, :s2]),
                  "the skip copied bit for bit")
        n_bytes = (x.numel() + got.numel() + (0 if skip is None else skip.numel())) * 2
        cases[where] = {"shape": list(got.shape), "max_abs_err": diff.max().item(),
                        "ms": time_kernel(lambda: dcunet_epilogue(*args)),
                        "plain_ms": time_kernel(lambda: dcunet_epilogue_plain(*args)),
                        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        del got, again, want, diff
    torch.manual_seed(seed)
    model = make_dcunet(device=dev).to(torch.bfloat16)
    xin = (0.1 * torch.randn(B, 1, T, generator=g, device=dev)).to(torch.bfloat16)
    model.sample(xin)
    before = dcunet_epilogue.launches
    kernels = device_kernels(lambda: model.sample(xin))
    launches = dcunet_epilogue.launches - before
    layout = sorted({k for k in kernels if any(n in k for n in DCUNET_LAYOUT_KERNELS)})
    check(launches == 2 * len(model.module.stages) - 1 and not layout,
          f"a Large-DCUNet-20 inference runs the epilogue a normed block and no layout "
          f"transpose, padding or cat ({launches} launches; {layout})")
    return {"name": "dcunet_epilogue", "route": "cuda",
            "source": "remfx_tpu_torch/csrc/dcunet_epilogue.cu", "replaces": None,
            "cases": cases,
            "ms": sum(c["ms"] for c in cases.values()),
            "plain_ms": sum(c["plain_ms"] for c in cases.values()),
            "bound_ms": sum(c["bound_ms"] for c in cases.values()),
            "bound_by": "bytes",
            "launches_per_dcunet_forward": launches}


def blstm_graph_row(seed: int) -> dict:
    """One forward of the chain's HDemucs at 24 rows (bf16, 262144 samples,
    seeded weights) with its BLSTMs eager (``graph_engages`` held false)
    and with them replaying their CUDA graphs: each side's median over 5
    forwards of the host's enqueue ms (the call's return, the card idle at
    its start) beside its ms between CUDA events around the call, which
    the host's pace sets where it is the slower; the device kernels a
    forward (torch.profiler); the graphed output equal to the eager one bit
    for bit on three forwards; and the BLSTM counters' moves."""
    from remfx_tpu_torch.models import demucs

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    model = make_demucs(device=dev).to(torch.bfloat16).eval()
    x = (0.1 * torch.randn(24, 1, T, generator=g, device=dev)).to(torch.bfloat16)

    def forward():
        return model(x)

    def timed() -> dict:
        enqueue, event = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            forward()
            b.record()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            event.append(a.elapsed_time(b))
        return {"enqueue_ms": statistics.median(enqueue), "event_ms": statistics.median(event),
                "kernels": sum(device_kernel_counts(forward).values())}

    counts = (demucs.BLSTM.card_calls, demucs.BLSTM.graph_captures, demucs.BLSTM.graph_replays)
    with torch.no_grad():
        engages = demucs.graph_engages
        demucs.graph_engages = lambda *case: False
        try:
            want = forward()
            eager = timed()
        finally:
            demucs.graph_engages = engages
        moved = [(demucs.BLSTM.card_calls, demucs.BLSTM.graph_captures,
                  demucs.BLSTM.graph_replays)]
        got = [forward() for _ in range(3)]
        torch.cuda.synchronize()
        equal = [torch.equal(y, want) for y in got]
        check(all(equal), f"the graphed HDemucs equals the eager one bit for bit: {equal}")
        graphed = timed()
    moved.append((demucs.BLSTM.card_calls, demucs.BLSTM.graph_captures,
                  demucs.BLSTM.graph_replays))
    blocks = sum(1 for m in model.modules() if isinstance(m, demucs.BLSTM))
    check(moved[0] == counts, f"the eager side counts no card call: {counts} -> {moved[0]}")
    calls, captures, replays = (b - a for a, b in zip(moved[0], moved[1]))
    check(captures == blocks and replays == calls - blocks,
          f"{blocks} BLSTMs: one eager call and one capture each, then replays "
          f"({calls} calls, {captures} captures, {replays} replays)")
    return {"name": "blstm_graph", "shape": [24, 1, T], "dtype": "bf16", "blstms": blocks,
            "eager": eager, "graphed": graphed, "equal": equal,
            "card_calls": calls, "graph_captures": captures, "graph_replays": replays}


def group_norm_row(seed: int) -> dict:
    """HDemucs's GroupNorm kernel at the chain's shapes (24 rows of an
    HDemucs stage, bf16): the largest time-branch norm and a frequency-
    branch one, each epilogue, against the plain composition in fp32 from
    the same bf16 inputs and bit for bit against itself; "ms" by events over
    back-to-back calls, "plain_ms" the plain composition in bf16 on the card
    (torch's F.group_norm and activation, which is also the library's
    call); the bytes bound reads x and the residual and writes the output
    once. Then one forward of the chain's HDemucs (bf16, 262144 samples):
    the kernel's launches, and that no torch GroupNorm kernel ran. Then
    every norm of the main path's HDemucs in fp32 against fp64."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = {}
    for where, shape in GN_SHAPES.items():
        C = shape[1]
        x = (0.3 + torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
        w = (1.0 + 0.5 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
        half = (shape[0], C // 2, *shape[2:])
        res = torch.randn(half, generator=g, device=dev).to(torch.bfloat16)
        scale = (0.3 * torch.randn(C // 2, generator=g, device=dev)).to(torch.bfloat16)
        for act in GN_ACTS:
            extra = (res, scale) if act == "glu+residual" else (None, None)
            args = (x, 1, w, b, 1e-5, act.split("+")[0], *extra)
            with torch.no_grad():
                got = group_norm(*args)
                again = group_norm(*args)
                want = group_norm_plain(*(t.float() if torch.is_tensor(t) else t
                                          for t in args))
                diff = (got.float() - want).abs()
                err = (diff - GN_RTOL * want.abs()).max().item()
                check(torch.equal(got, again), f"group_norm repeats bit for bit ({where}, {act})")
                check(err <= GN_ATOL, f"group_norm within {GN_RTOL} + {GN_ATOL} of the fp32 "
                      f"composition ({where}, {act}): {err}")
                torch_err = (group_norm_plain(*args).float() - want).abs().max().item()
                n_bytes = (x.numel() + got.numel() + (res.numel() if extra[0] is not None
                                                      else 0)) * 2
                cases[f"{where}.{act}"] = {
                    "shape": list(shape), "max_abs_err": diff.max().item(),
                    "torch_bf16_max_abs_err": torch_err,
                    "ms": time_kernel(lambda: group_norm(*args)),
                    "plain_ms": time_kernel(lambda: group_norm_plain(*args)),
                    "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
            del got, again, want, diff
    torch.manual_seed(seed)
    model = make_demucs(device=dev).to(torch.bfloat16)
    xin = (0.1 * torch.randn(1, 1, T, generator=g, device=dev)).to(torch.bfloat16)
    before = group_norm.launches
    with torch.no_grad():
        forward_kernels = device_kernels(lambda: model(xin))
    launches = group_norm.launches - before
    moments = [k for k in forward_kernels if "RowwiseMoments" in k]
    check(launches > 0 and not moments, "HDemucs's norms run the kernel and no torch "
          f"GroupNorm kernel ({launches} launches, {len(moments)} RowwiseMoments)")
    return {"name": "group_norm", "route": "cuda",
            "source": "remfx_tpu_torch/csrc/group_norm.cu", "replaces": None,
            "cases": cases,
            "ms": sum(c["ms"] for c in cases.values()),
            "plain_ms": sum(c["plain_ms"] for c in cases.values()),
            "library_ms": sum(c["plain_ms"] for c in cases.values()),
            "bound_ms": sum(c["bound_ms"] for c in cases.values()),
            "bound_by": "bytes",
            "launches_per_hdemucs_forward": launches,
            "main_path_fp32": group_norm_main_path(seed)}


def synth_renderer(dev) -> EffectChainRenderer:
    """The dataset's chain at the repo's default configuration
    (config/core.py): keep 2 of {reverb, chorus, delay}, shuffled; remove
    {compressor, distortion}, not shuffled; all.yaml's ranges; -20 LUFS
    after every effect and at the end; the MR-STFT redraw check."""
    cfg = default_config()
    return EffectChainRenderer(
        cfg["sample_rate"], cfg["effects_to_keep"], cfg["effects_to_remove"],
        cfg["num_kept_effects"], cfg["num_removed_effects"],
        cfg["shuffle_kept_effects"], cfg["shuffle_removed_effects"],
        effect_overrides=cfg["effects"], device=dev)


def wall_ms(fn, rounds: int = 3) -> float:
    """Median wall ms of ``rounds`` calls of ``fn``, each ended by a
    synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def trace_device(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler, tracing the card only (a
    trace of the host ops too takes tens of seconds to read back at tens
    of thousands of launches): its device kernels, their summed device
    time against the call's wall time (which the profiler inflates), and
    the kernels that took the most device time, by name (cut to 80
    characters) with their launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms_ = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_kernels": sum(e.count for e in kernels),
            "device_busy_ms": busy_ms, "wall_ms_traced": wall_ms_,
            "device_busy_share": busy_ms / wall_ms_,
            "top_kernels": [{"name": e.key[:80], "launches": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]]}


def golden_cases(golden, effect: str):
    """(params, oracle output, range overrides) of each fixture case of
    ``effect``, under the port's parameter names (as
    tests/test_golden_fixtures.py maps them)."""
    idxs = sorted({k.split("/")[1] for k in golden.files
                   if k.startswith(f"{effect}/")})
    for i in idxs:
        p = {k.split("/param/")[1]: float(golden[k]) for k in golden.files
             if k.startswith(f"{effect}/{i}/param/")}
        kw = {}
        if effect == "chorus":
            p["centre_delay_ms"] = p.pop("centre_ms")
        elif effect == "reverb":
            p = {"room_size": p["room_size"], "damping": p["damping"],
                 "wet_dry": p["wet_level"], "width": p["width"]}
            kw = {"max_room_size": max(0.5, p["room_size"])}
        elif effect == "delay":
            kw = {"max_delay_sconds": 0.3}
        yield p, golden[f"{effect}/{i}/output"], kw


def golden_on_card(dev) -> dict:
    """Each effect of the oracle's fixtures rendered on the card; the
    worst absolute error of its cases against its tolerance."""
    golden = np.load(GOLDEN)
    x = torch.from_numpy(golden["input"][None]).to(dev)
    worst = {}
    for effect, tol in GOLDEN_TOL.items():
        errs = []
        for p, ref, kw in golden_cases(golden, effect):
            eff = make_effect(effect, SR, device=dev, **kw)
            y = eff.render(x, {k: torch.tensor(v, dtype=torch.float32, device=dev)
                               for k, v in p.items()})
            errs.append(float(np.abs(y[0].cpu().numpy() - ref).max()))
        worst[effect] = {"max_abs_err": max(errs), "tol": tol, "cases": len(errs)}
        check(max(errs) < tol, f"golden {effect}: {max(errs)} < {tol}")
    return worst


def synth_phase(clips: torch.Tensor, seed: int) -> dict:
    """The data-synthesis path: render_batch of the dataset's chain on the
    8 demo clips at full width, with its checks, card against CPU, the
    oracle's golden outputs, and its times."""
    dev = clips.device
    cfg = default_config()
    x = clips[:, None, :]
    r = synth_renderer(dev)
    # ---- the synthesis path: counts at 0 just before, read just after ----
    envelope.launches = 0
    out = r.render_batch(torch.Generator().manual_seed(seed), x)
    torch.cuda.synchronize()
    launches = envelope.launches
    # ---- end of the synthesis path ----
    dry, wet, dry_labels, wet_labels = out
    check(launches >= 1, "the synthesis path launched the envelope kernel")
    for name, y in (("dry", dry), ("wet", wet)):
        check(y.shape == (B, 1, T), f"synth {name} (8, 1, 262144)")
        check(bool(torch.isfinite(y).all()), f"synth {name} finite")
    keep = [ALL_EFFECTS.index(n) for n in cfg["effects_to_keep"]]
    remove = torch.zeros(len(ALL_EFFECTS), device=dev)
    remove[[ALL_EFFECTS.index(n) for n in cfg["effects_to_remove"]]] = 1.0
    check(bool((dry_labels.sum(1) == 2).all() and (dry_labels[:, keep].sum(1) == 2).all()),
          "every dry row has exactly two of reverb / chorus / delay")
    check(bool((wet_labels == remove).all()), "every wet row is {compressor, distortion}")
    lufs = torch.cat([integrated_loudness(dry, SR), integrated_loudness(wet, SR)])
    lufs_err = (lufs + 20.0).abs().max().item()
    check(lufs_err <= LUFS_TOL, f"LUFS of every output row -20 within {LUFS_TOL}: {lufs_err}")

    again = r.render_batch(torch.Generator().manual_seed(seed), x)
    check(all(torch.equal(a, b) for a, b in zip(out[2:], again[2:])),
          "the same seed gives the same labels")
    rerun_err = max(max_rel(again[0], dry), max_rel(again[1], wet))
    check(rerun_err <= 1e-6, f"the same seed gives the same output: {rerun_err}")
    bit_equal = all(torch.equal(a, b) for a, b in zip(out, again))

    xs = x[..., :SYNTH_CPU_T]
    card = r.render_batch(torch.Generator().manual_seed(seed), xs)
    cpu = synth_renderer("cpu").render_batch(torch.Generator().manual_seed(seed), xs.cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card[2:], cpu[2:])),
          "card and CPU draw the same labels")
    cpu_err = max(max_rel(card[0], cpu[0]), max_rel(card[1], cpu[1]))
    check(cpu_err <= SYNTH_CPU_TOL, f"synth card vs CPU {cpu_err} <= {SYNTH_CPU_TOL}")

    golden = golden_on_card(dev)

    render_ms = wall_ms(lambda: r.render_batch(torch.Generator().manual_seed(seed), x))
    trace = trace_device(lambda: r.render_batch(torch.Generator().manual_seed(seed), x))
    gen = torch.Generator().manual_seed(seed)
    effect_ms = {}
    for name in ("reverb", "chorus", "delay", "compressor", "distortion", "limiter",
                 "parametric_eq", "volume_automation", "stereo_widener"):
        eff = make_effect(name, SR, device=dev, **cfg["effects"].get(name, {}))
        xin = torch.cat([x, x.roll(T // 2, -1)], 1) if name == "stereo_widener" else x
        params = eff.sample_params(gen, B)
        effect_ms[name] = wall_ms(lambda: eff.render_batch(xin, params))
    effect_ms["loudness_normalize"] = wall_ms(lambda: loudness_normalize(x, SR, -20.0))
    effect_ms["mrstft_check"] = wall_ms(lambda: r.stft_distance(wet, dry))

    limiter = make_effect("limiter", SR, device=dev)
    params = limiter.sample_params(gen, B)
    envelope.launches = 0
    limiter.render_batch(x, params)
    torch.cuda.synchronize()
    limiter_launches = envelope.launches
    check(limiter_launches == 2, "the limiter launched the envelope kernel twice")
    return {"envelope_launches": launches, "limiter_envelope_launches": limiter_launches,
            "dry_per_effect": per_effect(dry_labels), "wet_per_effect": per_effect(wet_labels),
            "lufs_max_err": lufs_err, "mrstft_min": float(r.stft_distance(wet, dry).min()),
            "rerun_bit_equal": bit_equal, "rerun_max_rel_err": rerun_err,
            "cpu_samples": SYNTH_CPU_T, "cpu_max_rel_err": cpu_err, "golden": golden,
            "render_batch_ms": render_ms, "render_batch_trace": trace,
            "audio_s_per_call": B * T / SR,
            "audio_s_per_s": B * T / SR / (render_ms / 1e3), "effect_ms": effect_ms}


def build_slots(dev):
    """The Cnn14 classifier and the five removal slots at full width, with
    the weights torch draws after ``torch.manual_seed``."""
    cls = make_cnn14(num_classes=len(ALL_EFFECTS), sample_rate=SR, device=dev,
                     **CNN14)
    tcn = make_tcn(sample_rate=SR, device=dev, **TCN)
    check(tcn.output_length(T) == T_OUT, f"TCN output length {T_OUT}")
    slots = {"RandomPedalboardDistortion": tcn, SLOT: demucs_slot(dev)}
    for name in ("RandomPedalboardReverb", "RandomPedalboardChorus",
                 "RandomPedalboardDelay"):
        slots[name] = make_dcunet(sample_rate=SR, device=dev, **DCUNET)
    return cls, slots


def demucs_slot(dev) -> ModelWrapper:
    """HDemucs at the compressor checkpoint's width in a residual wrapper,
    with torch-default (nonzero) init: identity_init's zeroed final convs
    would make the stage a no-op."""
    return ModelWrapper(make_demucs(sample_rate=SR, device=dev, **DEMUCS).module,
                        name="demucs", residual=True)


def per_effect(labels: torch.Tensor) -> dict:
    return dict(zip(ALL_EFFECTS, labels.sum(dim=0).int().tolist()))


def rms(x: torch.Tensor) -> float:
    return x.double().pow(2).mean().sqrt().item()


def bits_pattern(rows: int, dev) -> torch.Tensor:
    """Row i has the bits of i (mod 8) in slots 0-2 (reverb, chorus, delay)
    and those of 7 - i in slots 3-4 (distortion, compressor): every slot
    on in some rows and off in others."""
    v = [(i % 8) | ((7 - i % 8) << 3) for i in range(rows)]
    return torch.tensor([[(x >> j) & 1 for j in range(len(ALL_EFFECTS))]
                         for x in v], dtype=torch.float32, device=dev)


def spread_labels(counts: dict, rows: int, dev) -> torch.Tensor:
    """(rows, 5) labels with ``counts[effect]`` rows on, spread out."""
    labels = torch.zeros(rows, len(ALL_EFFECTS))
    for effect, n in counts.items():
        j = ALL_EFFECTS.index(effect)
        labels[[(i * (2 * j + 3) + j) % rows for i in range(rows)][:n], j] = 1.0
    return labels.to(dev)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the peak of ``want`` (in float64)."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def dispatch_phase(slots: dict, wet, clips, y_oracle) -> dict:
    """Regroup and staged against single on 16 rows (the rendered batch
    and its dry clips) whose labels give every kind of regroup stage: an
    empty slot (crop only), sub-batches (a bucket of 8) and dense stages;
    then all three modes with every label on, bit for bit."""
    x = torch.cat([wet, clips[:, None, :]])
    rows = x.shape[0]
    labels = spread_labels(DISPATCH_COUNTS, rows, x.device)
    kinds = {e: "empty" if n == 0 else
             "sub_batch" if (bucket_size(n, rows) or rows) < rows else "dense"
             for e, n in DISPATCH_COUNTS.items()}
    check({"empty", "sub_batch", "dense"} <= set(kinds.values()),
          "the dispatch pattern has an empty, a sub-batch and a dense stage")
    out, seconds = {}, {}
    for mode in ("single", "staged", "regroup"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode], _ = ChainInference(slots, SR, dispatch=mode).run(x, labels)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
        check(out[mode].shape == (rows, 1, T_OUT), f"{mode} output (16, 1, {T_OUT})")
        check(bool(torch.isfinite(out[mode]).all()), f"{mode} output finite")
    errs = {m: max_rel(out[m], out["single"]) for m in ("staged", "regroup")}
    for m, e in errs.items():
        check(e <= CPU_TOL, f"{m} vs single {e} <= {CPU_TOL} x peak")
    ones = torch.ones(B, len(ALL_EFFECTS), device=wet.device)
    all_on_equal = all(
        torch.equal(ChainInference(slots, SR, dispatch=mode).run(wet, ones)[0],
                    y_oracle) for mode in ("staged", "regroup"))
    check(all_on_equal, "staged and regroup with every label on equal single "
          "bit for bit")
    return {"rows": rows, "per_effect": DISPATCH_COUNTS, "stage_kinds": kinds,
            "staged_max_rel_err": errs["staged"],
            "regroup_max_rel_err": errs["regroup"],
            "staged_bit_equal": torch.equal(out["staged"], out["single"]),
            "all_on_bit_equal": all_on_equal, "mode_seconds": seconds}


def cpu_vs_card(cls, slots: dict, wet, dry) -> dict:
    """Clip 0 on the CPU with the same weights: the classifier and the
    HDemucs slot at full width (with an fp64 run, which says which side
    carries the error), then the five-slot chain and test_step on its
    first CPU_T samples."""
    cpu = torch.device("cpu")
    cls_cpu = copy.deepcopy(cls).to(cpu)
    slots_cpu = {k: copy.deepcopy(w).to(cpu) for k, w in slots.items()}
    with torch.no_grad():
        probs_card = cls(wet[:1]).cpu()
        probs_cpu = cls_cpu(wet[:1].cpu())
    probs_err = (probs_card - probs_cpu).abs().max().item()
    check(probs_err <= CPU_TOL, f"probs card vs CPU {probs_err} <= {CPU_TOL}")

    demucs_card = slots[SLOT].sample(wet[:1]).cpu()
    demucs_cpu = slots_cpu[SLOT].sample(wet[:1].cpu())
    demucs_64 = copy.deepcopy(slots_cpu[SLOT]).double().sample(wet[:1].cpu().double())
    demucs_rel = max_rel(demucs_cpu, demucs_card)
    check(demucs_rel <= CPU_TOL, f"HDemucs card vs CPU {demucs_rel} <= {CPU_TOL}")

    x0, d0 = wet[:1, :, :CPU_T], dry[:1, :, :CPU_T]
    ones = torch.ones(1, len(ALL_EFFECTS))
    y_card, _ = ChainInference(slots, SR).remove(x0, ones.to(x0.device))
    y_cpu, _ = ChainInference(slots_cpu, SR).remove(x0.cpu(), ones)
    chain_rel = max_rel(y_cpu, y_card)
    check(chain_rel <= CPU_TOL, f"five-slot chain card vs CPU {chain_rel} <= {CPU_TOL}")
    m_card = ChainInference(slots, SR).test_step((x0, d0, 0, ones.to(x0.device)))
    m_cpu = ChainInference(slots_cpu, SR).test_step((x0.cpu(), d0.cpu(), 0, ones))
    metric_errs = {}
    for k in m_card:
        a, b = m_card[k].item(), m_cpu[k].item()
        metric_errs[k] = abs(a - b) / max(abs(b), 1.0)
        check(metric_errs[k] <= CPU_TOL, f"test_step {k} card {a} vs CPU {b}")
    return {"probs_max_abs_err": probs_err,
            "demucs_max_rel_err": demucs_rel,
            "demucs_card_vs_fp64": max_rel(demucs_card, demucs_64),
            "demucs_cpu_vs_fp64": max_rel(demucs_cpu, demucs_64),
            "chain_samples": CPU_T, "chain_length_out": y_cpu.shape[-1],
            "chain_max_rel_err": chain_rel,
            "test_step_rel_err": metric_errs}


# ---------------------------------------------------------------- bf16

# bench.py's chain (bench.py:79-115; the reference's cfg/exp/remfx_detect.
# yaml): HDemucs removes distortion and compression, Large-DCUNet-20
# reverb, chorus and delay, Cnn14 detects. Each slot at its trained
# checkpoint's settings (DEMUCS in the residual wrapper, DCUNET with
# identity_init), so every stage keeps the signal's scale: at torch's
# default init without them a Large-DCUNet-20 scales its input down by
# about 1e-4, and the error of a vanishing signal says nothing
BENCH_KINDS = {"RandomPedalboardDistortion": "demucs", SLOT: "demucs",
               "RandomPedalboardReverb": "dcunet", "RandomPedalboardChorus": "dcunet",
               "RandomPedalboardDelay": "dcunet"}
BF16_B = 32  # bench.py's batch: the 8 demo clips, each four times
BF16_SAMPLE_B = 16  # scripts/bench_stages.py's batch
BF16_P = 0.5  # each oracle label on with this probability (bench.py's regroup row)
BF16_ROUNDS = 3  # timed passes a row, after one warm-up
# max |bf16 - fp32| / RMS(fp32) of the chain's output at the same weights
# and labels; tests/test_torch_dtype.py holds this composition at a small
# width to it. A faulty bf16 chain must read above it: the same pass with
# one of these stages skipped (a Large-DCUNet-20, an HDemucs)
BF16_CHAIN_TOL = 0.2
BF16_SKIPPED = ("reverb", "compressor")
# max |bf16 - fp32| / RMS(fp32) of Cnn14's 2048-d embedding, as
# tests/test_torch_dtype.py holds the port's to the JAX package's
CNN14_BF16_TOL = 0.06
BF16_MARGIN = 0.05  # fp32 probabilities this far from the threshold: equal labels


def bench_slots(dev):
    """Cnn14 and bench.py's five slots at full width, with the weights
    torch draws after ``torch.manual_seed``."""
    cls = make_cnn14(num_classes=len(ALL_EFFECTS), sample_rate=SR, device=dev, **CNN14)
    slots = {name: demucs_slot(dev) if kind == "demucs"
             else make_dcunet(sample_rate=SR, device=dev, **DCUNET)
             for name, kind in BENCH_KINDS.items()}
    return cls, slots


def timed_rounds(fn) -> tuple:
    """(the last result, wall ms of each of BF16_ROUNDS calls after one
    warm-up, the peak GiB allocated over them), the card synchronised
    around each call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(BF16_ROUNDS):
        out, ms = timed_ms(fn)
        times.append(ms)
    return out, times, torch.cuda.max_memory_allocated() / 2**30


def bf16_phase(seed: int, clips: torch.Tensor) -> dict:
    """bench.py's chain at 32 x 262144, regroup, in bf16 (every parameter,
    buffer and the input cast) and in fp32 from the same weights: the
    oracle row (detect timed beside the removal of fixed labels) and the
    detect-driven row (labels that depend on the classifier's output and
    equal the oracle's), as audio seconds per second; each backbone's
    ``sample`` at 16 x 262144 in both; a trace of one oracle pass in each
    dtype; bf16 against fp32: the chain's output (and, as a control, with
    a stage skipped), Cnn14's embedding and its labels."""
    dev = clips.device
    torch.manual_seed(seed)
    cls, slots = bench_slots(dev)
    nets = {"fp32": (cls, slots),
            "bf16": (copy.deepcopy(cls).to(torch.bfloat16),
                     {k: copy.deepcopy(w).to(torch.bfloat16) for k, w in slots.items()})}
    x = clips.repeat(BF16_B // B, 1)[:, None, :]
    gen = torch.Generator().manual_seed(seed)
    oracle = (torch.rand(BF16_B, len(ALL_EFFECTS), generator=gen) < BF16_P).float().to(dev)
    audio_s = BF16_B * T / SR
    rows, out, probs, embed = {}, {}, {}, {}
    for dtype, (c, models) in nets.items():
        xd = x.to(torch.bfloat16) if dtype == "bf16" else x
        detector = ChainInference({}, SR, classifier=c)
        remover = ChainInference(models, SR, dispatch="regroup")

        def oracle_row():
            labels = detector.detect(xd)
            return remover.run(xd, oracle)[0], labels

        def detect_row():
            labels = detector.detect(xd)
            return remover.run(xd, oracle + 0.0 * labels)[0], labels

        for row, fn in (("oracle", oracle_row), ("detect_driven", detect_row)):
            (y, _), ms, peak = timed_rounds(fn)
            check(y.dtype == xd.dtype and y.shape == x.shape,
                  f"{row} {dtype} output {y.dtype} {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"{row} {dtype} output finite")
            rows[f"{row}_{dtype}"] = {"ms": ms, "audio_s_per_s": audio_s / (statistics.median(ms) / 1e3),
                                      "peak_allocated_gib": peak}
            out.setdefault(dtype, {})[row] = y
        rows[f"oracle_{dtype}"]["trace"] = trace_device(oracle_row, top=8)
        check(torch.equal(out[dtype]["oracle"], out[dtype]["detect_driven"]),
              f"{dtype}: the detect-driven row removes what the oracle row removes")
        with torch.no_grad():
            probs[dtype], embed[dtype] = c(xd), c.embed(xd)
        check(probs[dtype].dtype == xd.dtype, f"{dtype} probabilities {probs[dtype].dtype}")
        del detector, remover

    want = out["fp32"]["oracle"]
    err = max_rel_rms(out["bf16"]["oracle"], want)
    check(err <= BF16_CHAIN_TOL, f"bf16 chain against fp32 {err} <= {BF16_CHAIN_TOL} x RMS")
    skipped = {}
    for effect in BF16_SKIPPED:
        labels = oracle.clone()
        labels[:, ALL_EFFECTS.index(effect)] = 0
        y = ChainInference(nets["bf16"][1], SR, dispatch="regroup").run(
            x.to(torch.bfloat16), labels)[0]
        skipped[effect] = max_rel_rms(y, want)
        check(skipped[effect] > BF16_CHAIN_TOL,
              f"bf16 chain with the {effect} stage skipped {skipped[effect]} > {BF16_CHAIN_TOL}")
    embed_err = max_rel_rms(embed["bf16"], embed["fp32"])
    check(embed_err <= CNN14_BF16_TOL,
          f"Cnn14 bf16 embedding against fp32 {embed_err} <= {CNN14_BF16_TOL} x RMS")
    p32, p16 = probs["fp32"].float(), probs["bf16"].float()
    clear = (p32 - 0.5).abs() > BF16_MARGIN
    equal = int(((p16 > 0.5) == (p32 > 0.5))[clear].sum())
    check(equal == int(clear.sum()), f"labels equal where fp32 clears the margin: "
          f"{equal} of {int(clear.sum())}")

    sample = {}
    xs = x[:BF16_SAMPLE_B]
    for kind, (slot, name) in {"demucs": (SLOT, "HDemucs"),
                               "dcunet": ("RandomPedalboardReverb", "Large-DCUNet-20"),
                               "cnn14": (None, "Cnn14")}.items():
        for dtype, (c, models) in nets.items():
            xd = xs.to(torch.bfloat16) if dtype == "bf16" else xs
            net = c if slot is None else models[slot].sample
            with torch.no_grad():
                y, ms, peak = timed_rounds(lambda: net(xd))
            check(y.dtype == xd.dtype and bool(torch.isfinite(y).all()),
                  f"{name} {dtype} sample finite in {xd.dtype}")
            sample[f"{kind}_{dtype}"] = {"ms": ms, "ms_median": statistics.median(ms),
                                         "peak_allocated_gib": peak}
    speedups = {r: rows[f"{r}_bf16"]["audio_s_per_s"] / rows[f"{r}_fp32"]["audio_s_per_s"]
                for r in ("oracle", "detect_driven")}
    speedups.update({k: sample[f"{k}_fp32"]["ms_median"] / sample[f"{k}_bf16"]["ms_median"]
                     for k in ("demucs", "dcunet", "cnn14")})
    return {"batch": BF16_B, "samples": T, "sample_batch": BF16_SAMPLE_B,
            "oracle_per_effect": per_effect(oracle), "rows": rows, "sample": sample,
            "speedup_bf16": speedups, "max_abs_err_over_rms": err,
            "tol": BF16_CHAIN_TOL, "skipped_err_over_rms": skipped,
            "cnn14_embed_err_over_rms": embed_err, "cnn14_tol": CNN14_BF16_TOL,
            "labels_compared": int(clear.sum()),
            "labels_equal": equal, "out_dtype": str(out["bf16"]["oracle"].dtype),
            "probs_max_abs_diff": (p16 - p32).abs().max().item()}


def bf16_run(seed: int, clips: torch.Tensor) -> dict:
    """The bf16 phase with the kernels' launches on its path (counts at 0
    just before, read just after)."""
    phaser.launches = envelope.launches = 0
    gn_before = group_norm.launches
    out = bf16_phase(seed, clips)
    torch.cuda.synchronize()
    out["launches"] = {"envelope": envelope.launches, "phaser": phaser.launches,
                       "group_norm": group_norm.launches - gn_before}
    check(out["launches"]["group_norm"] > 0, "bf16's HDemucs launched the GroupNorm kernel")
    return out


def max_rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the RMS of ``want`` (in float64)."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


# ---------------------------------------------------------------- training

# the JAX package's `scripts/train.py +exp=compression_aug` on the dynamic
# synthetic dataset: HDemucs (nfft 4096, channels 48, mono) removing the
# compressor, with 0-4 of distortion, chorus, delay and reverb kept
TRAIN_ARGS = ["+exp=compression_aug", "datamodule.dataset_type=dynamic",
              "datamodule.synthetic=true"]
TRAIN_B = 16  # the experiment's train_batch_size (the paper's batch)
TRAIN_STEPS = 4  # fit's steps; the resumed run takes RESUME_STEPS more
RESUME_STEPS = 2
TIMED_STEPS = 3  # render + train_step, each timed, on fresh batches
FIT_STEPS = 4  # train_steps on one fixed batch, whose loss must fall
TRAIN_CPU_T = 65536  # samples of the card-against-CPU train step
TRAIN_CPU_TOL = 1e-4  # loss, relative: fp32, TF32 off on the card
# a bf16-mixed step's loss against the fp32 step's from the same weights,
# relative: tests/test_torch_train.py's bound, one bf16 ulp
TRAIN_BF16_TOL = 2.0 ** -8
CLS_ARGS = ["+exp=5-5_full_cls_dynamic", "datamodule.synthetic=true"]
CLS_B = 32  # 5-5_full_cls_dynamic's train_batch_size
CLS_STEPS = 2


def train_cfg(args, seed: int, logs: Path, *extra):
    return parse_cli(args + [
        f"seed={seed}", f"logs_dir={logs}", f"render_root={logs / 'data'}",
        "logger=csv"] + list(extra))


def finite_metrics(metrics: dict, what: str):
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    check(not bad, f"{what} metrics finite: {bad}")


def csv_rows(logs: Path) -> list:
    rows = []
    for path in sorted(logs.glob("remfx_tpu/version_*/metrics.csv")):
        with open(path) as f:
            rows += list(csv.DictReader(f))
    return rows


def device_kernel_counts(fn) -> collections.Counter:
    """Launches of each device kernel, by name, in a torch.profiler trace
    of the card only over one call of ``fn`` (a trace of the host ops too
    takes seconds to read back at thousands of launches; a trace of the
    card only can miss the call's first kernel, so the envelope's are
    counted after a render)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA})


def cpu_train_step(task, batch) -> dict:
    """One train_step of a copy of ``task``'s HDemucs on the host CPU and
    one on the card, from the same weights and batch: the loss's relative
    difference and the largest parameter difference after the step."""
    on_cpu = copy.deepcopy(task.wrapper).cpu()
    # the card's copy made by .to(), which lays the LSTM's weights out
    # as cuDNN takes them
    wrappers = {"cuda": copy.deepcopy(on_cpu).to("cuda"), "cpu": on_cpu}
    out = {}
    for dev, w in wrappers.items():
        t = RemovalTask(w, max_steps=100)
        state = t.init_state()
        x, y = (v.to(dev) for v in batch)
        _, m = t.train_step(state, (x, y))
        out[dev] = (m["train_loss"].item(), [p.detach().cpu() for p in w.parameters()])
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    param_err = max((a - b).abs().max().item() for a, b in zip(out["cuda"][1], out["cpu"][1]))
    check(loss_rel <= TRAIN_CPU_TOL, f"train_step loss card vs CPU {loss_rel}")
    # Adam moves each parameter by about lr (1e-4) a step: a difference
    # of more than two steps is a wrong update, not rounding
    check(param_err <= 2.05e-4, f"train_step parameters card vs CPU {param_err}")
    return {"samples": TRAIN_CPU_T, "rows": batch[0].shape[0], "loss_cpu": out["cpu"][0],
            "loss_card": out["cuda"][0], "loss_rel_err": loss_rel,
            "param_max_abs_err": param_err}


def train_phase(seed: int, logs: Path, env_names) -> dict:
    """fit / test / auto_resume of compression_aug at 16 x 262144 on the
    card, then timed steps, a fixed-batch fit and card against CPU."""
    cfg = train_cfg(TRAIN_ARGS, seed, logs, f"trainer.max_steps={TRAIN_STEPS}",
                    f"datamodule.train_chunks={TRAIN_B * TRAIN_STEPS}",
                    f"datamodule.val_chunks={TRAIN_B}", f"datamodule.test_chunks={TRAIN_B}",
                    f"datamodule.test_batch_size={TRAIN_B}")
    check(cfg["datamodule"]["train_batch_size"] == TRAIN_B
          and cfg["chunk_size"] == T and cfg["model"]["name"] == "demucs",
          "compression_aug trains HDemucs at 16 x 262144")
    # ---- the training path: counts at 0 just before, read just after ----
    envelope.launches = 0
    state, test_metrics = fit(cfg)
    torch.cuda.synchronize()
    fit_launches = envelope.launches
    # ---- end of the training path ----
    finite_metrics(test_metrics, "fit test")
    train_rows = [r for r in csv_rows(logs) if r.get("train_loss")]
    check(len(train_rows) == TRAIN_STEPS, f"{TRAIN_STEPS} train rows logged")
    finite_metrics({k: float(v) for r in train_rows for k, v in r.items()
                    if k.startswith("train_") and v}, "train")
    run = find_latest_run(str(logs))
    layout = sorted(p.name for p in run.iterdir())
    check(layout == ["best", "best_meta.json", "last", "last_meta.json"],
          f"the checkpoint layout: {layout}")
    check((run / "best" / "state.pt").is_file() and (run / "last" / "state.pt").is_file(),
          "best and last hold state.pt")
    meta = json.loads((run / "last_meta.json").read_text())
    check(meta["step"] == TRAIN_STEPS, f"last_meta step {meta}")

    best = read_state(str(run / "best"), next(state.model.parameters()).device)["model"]
    restored = build_task(cfg).init_state()
    restore_from(str(run / "best"), restored)
    bit_equal = all(torch.equal(v, best[k]) for k, v in restored.model.state_dict().items())
    check(bit_equal, "a restore of best equals the saved parameters bit for bit")
    check(all(torch.equal(v, best[k]) for k, v in state.model.state_dict().items()),
          "fit tested the best checkpoint's parameters")
    test_cfg = train_cfg(TRAIN_ARGS, seed, logs, "render_files=false",
                         f"ckpt_path={run / 'best'}", f"datamodule.val_chunks={TRAIN_B}",
                         f"datamodule.test_chunks={TRAIN_B}",
                         f"datamodule.test_batch_size={TRAIN_B}")
    again = test(test_cfg)
    test_rel = max(abs(again[k] - v) / max(abs(v), 1e-6) for k, v in test_metrics.items())
    check(test_rel <= 1e-6, f"test(ckpt_path=best) gives fit's test metrics: {test_rel}")

    resume_cfg = train_cfg(TRAIN_ARGS, seed, logs, "render_files=false",
                           "trainer.auto_resume=true",
                           f"trainer.max_steps={TRAIN_STEPS + RESUME_STEPS}",
                           f"datamodule.train_chunks={TRAIN_B * TRAIN_STEPS}",
                           f"datamodule.val_chunks={TRAIN_B}",
                           f"datamodule.test_chunks={TRAIN_B}",
                           f"datamodule.test_batch_size={TRAIN_B}")
    resumed, resume_metrics = fit(resume_cfg)
    finite_metrics(resume_metrics, "resumed test")
    rmeta = json.loads((find_latest_run(str(logs)) / "last_meta.json").read_text())
    check(resumed.step == TRAIN_STEPS + RESUME_STEPS and
          rmeta["step"] == TRAIN_STEPS + RESUME_STEPS,
          f"auto_resume continued at step {TRAIN_STEPS}: {resumed.step}, {rmeta}")

    # timed steps on fresh batches, as fit takes them
    task = build_task(cfg)
    tstate = task.init_state()
    data = build_datamodule(train_cfg(TRAIN_ARGS, seed, logs, "render_files=false",
                                      f"datamodule.val_chunks={TRAIN_B}",
                                      f"datamodule.test_chunks={TRAIN_B}"))
    ds = data.train_dataset
    render_ms, step_ms, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TIMED_STEPS):
        before = envelope.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ds.get_batch(np.arange(i * TRAIN_B, (i + 1) * TRAIN_B))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = task.train_step(tstate, (batch[0], batch[1]))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        render_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        per_step.append(envelope.launches - before)
        finite_metrics({k: v.item() for k, v in m.items()}, "timed step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(per_step == [1] * TIMED_STEPS, f"one envelope launch per training step: {per_step}")
    fixed = ds.get_batch(np.arange(TRAIN_B))
    counts = device_kernel_counts(
        lambda: task.train_step(tstate, ds.get_batch(np.arange(TRAIN_B))[:2]))
    env_kernels = sum(counts[n] for n in set(env_names))
    check(env_kernels == len(env_names),
          f"a traced render + step runs one envelope call's device kernels: {env_kernels}")

    step_trace = trace_device(lambda: task.train_step(tstate, fixed[:2]))

    fit_task = build_task(cfg)
    fit_state = fit_task.init_state()
    losses = []
    for _ in range(FIT_STEPS):
        _, m = fit_task.train_step(fit_state, (fixed[0], fixed[1]))
        losses.append(m["train_loss"].item())
    check(losses[-1] < losses[0], f"steps on one batch lower the loss: {losses}")

    cpu = cpu_train_step(fit_task, (fixed[0][:1, :, :TRAIN_CPU_T].contiguous(),
                                    fixed[1][:1, :, :TRAIN_CPU_T].contiguous()))
    del fit_task, fit_state
    half = bf16_mixed_steps(seed, logs, fixed[:2])
    step_med, render_med = statistics.median(step_ms), statistics.median(render_ms)
    audio_s = TRAIN_B * T / SR
    return {"fit_envelope_launches": fit_launches, "envelope_launches_per_step": per_step,
            "traced_step_envelope_kernels": env_kernels,
            "batch": TRAIN_B, "samples": T, "fit_steps": TRAIN_STEPS,
            "fit_test_metrics": test_metrics, "test_again_rel_err": test_rel,
            "resumed_step": resumed.step, "restore_bit_equal": bit_equal,
            "step_ms": step_ms, "render_ms": render_ms, "step_ms_median": step_med,
            "render_ms_median": render_med,
            "render_share": render_med / (render_med + step_med),
            "audio_s_per_step": audio_s,
            "train_audio_s_per_s": audio_s / (step_med / 1e3),
            "train_audio_s_per_s_with_render": audio_s / ((step_med + render_med) / 1e3),
            "peak_allocated_gib": peak, "step_trace": step_trace,
            "fixed_batch_losses": losses, "cpu_vs_card": cpu, "bf16_mixed": half}


def bf16_mixed_steps(seed: int, logs: Path, batch) -> dict:
    """compression_aug's step in bf16-mixed beside its fp32 step, each from
    the seed's weights on one batch: the first step's losses against each
    other, then both timed over TIMED_STEPS more steps, with their peaks."""
    out = {}
    for precision in ("32", "bf16-mixed"):
        task = build_task(train_cfg(TRAIN_ARGS, seed, logs, "render_files=false",
                                    f"trainer.precision={precision}"))
        check(task.precision == precision, f"the task trains in {precision}")
        state = task.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(1 + TIMED_STEPS):
            (_, m), ms = timed_ms(lambda: task.train_step(state, batch))
            losses.append(m["train_loss"].item())
            step_ms.append(ms)
        out[precision] = {"losses": losses, "step_ms": step_ms[1:],
                          "step_ms_median": statistics.median(step_ms[1:]),
                          "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
        finite_metrics({"loss": losses[-1]}, f"{precision} step")
        del task, state
    first = {p: v["losses"][0] for p, v in out.items()}
    rel = abs(first["bf16-mixed"] - first["32"]) / abs(first["32"])
    check(rel <= TRAIN_BF16_TOL,
          f"bf16-mixed step's loss against fp32's {rel} <= {TRAIN_BF16_TOL}")
    return {"fp32": out["32"], "bf16": out["bf16-mixed"], "first_loss_rel_err": rel,
            "speedup": out["32"]["step_ms_median"] / out["bf16-mixed"]["step_ms_median"]}


def train_cls_phase(seed: int, logs: Path, env_names) -> dict:
    """Two ClassifierTask steps of 5-5_full_cls_dynamic (Cnn14 with
    SpecAugment, 32 x 262144, mixup off) through fit on the card."""
    cfg = train_cfg(CLS_ARGS, seed, logs, f"trainer.max_steps={CLS_STEPS}",
                    f"datamodule.train_chunks={CLS_B * CLS_STEPS}",
                    f"datamodule.val_chunks={CLS_B}", f"datamodule.test_chunks={CLS_B}")
    m = cfg["model"]
    check(cfg["datamodule"]["train_batch_size"] == CLS_B and m["name"] == "cnn14"
          and m["network"]["specaugment"] and not m["mixup"],
          "5-5_full_cls_dynamic: Cnn14 with SpecAugment, batch 32, mixup off")
    # ---- the classifier's training path ----
    envelope.launches = 0
    state, test_metrics = fit(cfg)
    torch.cuda.synchronize()
    launches = envelope.launches
    # ---- end of the path ----
    finite_metrics(test_metrics, "classifier test")
    train_rows = [r for r in csv_rows(logs) if r.get("train_loss")]
    check(len(train_rows) == CLS_STEPS, f"{CLS_STEPS} classifier train rows")
    finite_metrics({k: float(v) for r in train_rows for k, v in r.items()
                    if k.startswith("train_") and v}, "classifier train")
    check(launches >= 1, "the classifier's renders launched the envelope kernel")
    return {"batch": CLS_B, "samples": T, "steps": state.step, "envelope_launches": launches,
            "train_loss": [float(r["train_loss"]) for r in train_rows],
            "test_metrics": test_metrics}


# ---------------------------------------------------------- trained weights

# the vendored checkpoints that every checkout carries, the trimmed copy
# of .chiprunignore included: the classifier and the four removers other
# than HDemucs, whose 130 MB do not fit beside the classifier's 124 MB
# in that copy
TRAINED_DIRS = ("classifier_cnn14_r5", "tcn_distortion_aug", "dcunet_reverb_aug_r4",
                "dcunet_chorus_aug_r5", "dcunet_delay_aug_r5")
TRAINED_SLOTS = ("RandomPedalboardDistortion", "RandomPedalboardReverb",
                 "RandomPedalboardChorus", "RandomPedalboardDelay")
# HDemucs' checkpoint, in a full checkout only; demo_detect's map then
# has the compressor slot too, and the phase runs it
COMPRESSOR_DIR, COMPRESSOR_SLOT = "demucs_compressor_aug_r5", "RandomPedalboardCompressor"
DEMO_IN = "demos/synth_distortion_reverb.wav"  # true effects: distortion, reverb
DEMO_DRY = "demos/synth_target.wav"
STREAM_FILES = ("example_distortion_reverb", "example_target",
                "synth_distortion_reverb", "synth_target")
STREAM_CHUNK, STREAM_OVERLAP = 262144, 16384  # stream_chain's defaults


def joined_clips() -> np.ndarray:
    """The four clips of STREAM_FILES joined end to end: (1, 1048576)."""
    joined = np.concatenate([read_wav(ROOT / "demos" / f"{f}.wav")[0]
                             for f in STREAM_FILES], axis=-1)
    return np.ascontiguousarray(joined, np.float32)


def trained_dirs(root: Path = ROOT) -> tuple[tuple, tuple]:
    """(the vendored checkpoint directories the trained phase reads, the
    removal slots demo_detect's map must then have): the five of
    TRAINED_DIRS always (a missing one fails), HDemucs' where ``root``
    holds it."""
    def vendored(name):
        return ((root / "ckpts" / name / "hparams.json").is_file()
                and (root / "ckpts" / name / "variables").is_dir())

    for name in TRAINED_DIRS:
        check(vendored(name), f"ckpts/{name} is in the checkout")
    with_compressor = vendored(COMPRESSOR_DIR)
    return (TRAINED_DIRS + (COMPRESSOR_DIR,) * with_compressor,
            TRAINED_SLOTS + (COMPRESSOR_SLOT,) * with_compressor)


def trained_phase(dev):
    """demo_detect's chain (the port's reader and build_chain, the
    vendored map restricted to the directories present) on the card:
    detect -> remove of the synthetic distortion + reverb clip at 262144
    samples against its dry target, the labels and the removal against
    the CPU, then stream_chain over four clips joined end to end.
    -> (the phase's line, the chain, its config)."""
    dirs, slots = trained_dirs()
    libzstd = ocdbt.libzstd()._name
    read_s = {}
    for name in dirs:
        t0 = time.perf_counter()
        restore_tree(ROOT / "ckpts" / name / "variables")
        read_s[name] = time.perf_counter() - t0
    with contextlib.chdir(ROOT):  # demo_detect's paths are relative
        cfg = trained_cfg(parse_cli(["+exp=remfx_detect"]))
        check(sorted(cfg["ckpts"]) == sorted(slots)
              and cfg["classifier_ckpt"] == "ckpts/classifier_cnn14_r5",
              f"the vendored map of the checkout: {sorted(cfg['ckpts'])}, "
              f"expected {sorted(slots)}")
        t0 = time.perf_counter()
        chain = build_chain(copy.deepcopy(cfg), None, device=dev)
        build_s = time.perf_counter() - t0
        chain_cpu = build_chain(copy.deepcopy(cfg), None, device="cpu")
    audio, sr = read_wav(ROOT / DEMO_IN)
    dry, _ = read_wav(ROOT / DEMO_DRY)
    check(sr == SR and audio.shape == (1, T) and dry.shape == (1, T),
          "the demo clip and its target: mono, 262144 samples")

    torch.cuda.reset_peak_memory_stats()
    # ---- the trained path: counts at 0 just before, read just after ----
    envelope.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, y = detect_remove(chain, audio, dry)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = envelope.launches
    # ---- end of the trained path ----
    peak = torch.cuda.max_memory_allocated() / 2**30
    check({"distortion", "reverb"} <= set(report["detected_effects"]),
          f"the clip's true effects detected: {report['detected_effects']}")
    check(y.shape == (1, T_OUT) and bool(np.isfinite(y).all()),
          f"trained output finite, (1, {T_OUT})")
    check(np.isfinite(report["input_si_sdr_db"])
          and np.isfinite(report["output_si_sdr_db"]), "SI-SDR finite")

    x = torch.from_numpy(audio)[None].to(dev)
    labels = chain.detect(x)
    detect_ms = wall_ms(lambda: chain.detect(x))
    remove_ms = wall_ms(lambda: chain.remove(x, labels))
    with torch.no_grad():
        probs_cpu = chain_cpu.classifier(x.cpu())
        probs_card = chain.classifier(x).cpu()
    labels_cpu = chain_cpu.detect(x.cpu())
    cpu_effects = [e for e, v in zip(ALL_EFFECTS, labels_cpu[0].tolist()) if v > 0.5]
    check(report["detected_effects"] == cpu_effects,
          f"card labels {report['detected_effects']} equal the CPU's {cpu_effects}")
    probs_err = (probs_card - probs_cpu).abs().max().item()
    check(probs_err <= CPU_TOL, f"trained probs card vs CPU {probs_err} <= {CPU_TOL}")
    x0 = x[..., :CPU_T]
    chain_rel = max_rel(chain_cpu.remove(x0.cpu(), labels_cpu)[0],
                        chain.remove(x0, labels)[0])
    check(chain_rel <= CPU_TOL, f"trained chain card vs CPU {chain_rel} <= {CPU_TOL}")

    # ---- stream: the same chain over four clips joined end to end ----
    xs = torch.from_numpy(joined_clips()).to(dev)
    starts = _windows(xs.shape[-1], STREAM_CHUNK, STREAM_CHUNK - STREAM_OVERLAP)
    envelope.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys, stream_labels = stream_chain(chain, xs, STREAM_CHUNK, STREAM_OVERLAP)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = envelope.launches
    check(ys.shape == xs.shape and bool(torch.isfinite(ys).all()),
          f"stream output finite, {tuple(xs.shape)}")
    frames = torch.stack([xs[:, s:s + STREAM_CHUNK] for s in starts])
    loudest = int(torch.argmax(frames.pow(2).mean(dim=(1, 2))))
    check(torch.equal(stream_labels, chain.detect(frames[loudest][None])[0]),
          "stream labels equal detect on the loudest window")
    one, _ = stream_chain(chain, xs[:, :STREAM_CHUNK], STREAM_CHUNK, STREAM_OVERLAP,
                          labels=stream_labels)
    want, _ = chain.remove(xs[None, :, :STREAM_CHUNK], stream_labels[None])
    check(torch.equal(one, want[0]), "one window equals chain.remove bit for bit")
    audio_s = xs.shape[-1] / SR
    return {"libzstd": libzstd, "compressor_ckpt": COMPRESSOR_DIR in dirs,
            "read_s": read_s, "build_s": build_s,
            "slots": {k: type(m.module).__name__ for k, m in chain.models.items()},
            "envelope_launches": launches, **report,
            "cpu_detected_effects": cpu_effects, "probs_max_abs_err": probs_err,
            "chain_samples": CPU_T, "chain_max_rel_err": chain_rel,
            "first_call_s": first_s, "detect_ms": detect_ms, "remove_ms": remove_ms,
            "peak_allocated_gib": peak,
            "stream": {"samples": xs.shape[-1], "windows": len(starts),
                       "chunk": STREAM_CHUNK, "overlap": STREAM_OVERLAP,
                       "labels": stream_labels.tolist(), "loudest_window": loudest,
                       "seconds": stream_s, "audio_s": audio_s,
                       "audio_s_per_s": audio_s / stream_s,
                       "envelope_launches": stream_launches,
                       "one_window_bit_equal": True}}, chain, cfg


# ------------------------------------------------ UMX, DPTNet and .ckpt files

UMX_DIR = "umx_reverb_synth"
UMX_B, UMX_T = 4, 65536  # tests/test_trained_ckpt.py's batch: the training chunk
DPT_TRAIN_B = 2  # DPTNet samples the demo batch and trains on two rows
DPT_CPU_T = 16384
DPT_STEPS = 3  # steps on one fixed batch, whose loss must fall
# card vs CPU for UMX and DPTNet, x peak: fp32 rounding is ~5e-7 there,
# TF32 in their matmuls or LSTMs ~1e-3 (each phase reports both readings)
BACKBONE_CPU_TOL = 1e-5
DEFAULT_ARGS = ["+exp=default", "datamodule.synthetic=true",
                "datamodule.dataset_type=dynamic"]
DEFAULT_STEPS = 2  # fit's steps; then DEFAULT_STEPS timed steps
COMPRESSOR = ALL_EFFECTS.index("compressor")


def umx_phase(seed: int, dev) -> dict:
    """ckpts/umx_reverb_synth through the port's orbax reader with the
    Wiener EM post-filter (niter=1): dereverb 4 x 65536 synthetic chunks
    rendered with the checkpoint's reverb ranges, as
    tests/test_trained_ckpt.py does; card against CPU on one row."""
    d = ROOT / "ckpts" / UMX_DIR
    check((d / "hparams.json").is_file() and (d / "variables").is_dir(),
          f"ckpts/{UMX_DIR} is in the checkout")
    t0 = time.perf_counter()
    effect, umx = load_trained_wrapper(d, device=dev, niter=1)
    load_s = time.perf_counter() - t0
    check(effect == "reverb" and umx.module.niter == 1, "the trained UMX, niter=1")
    hp = json.loads((d / "hparams.json").read_text())
    renderer = EffectChainRenderer(SR, effects_to_remove=("reverb",),
                                   num_removed_effects=(1, 1),
                                   effect_overrides=hp["effects"], device=dev)
    rng = np.random.default_rng(seed + 1)
    clean = np.stack([synthetic_chunk(rng, UMX_T, SR) for _ in range(UMX_B)])
    dry, wet, _, _ = renderer.render_batch(torch.Generator().manual_seed(seed + 5),
                                           torch.from_numpy(clean).to(dev))
    torch.cuda.reset_peak_memory_stats()
    # ---- the UMX path: counts at 0 just before, read just after ----
    envelope.launches = 0
    out = umx.sample(wet)
    torch.cuda.synchronize()
    launches = envelope.launches
    # ---- end of the path ----
    check(out.shape == wet.shape and bool(torch.isfinite(out).all()),
          f"UMX output finite, {tuple(wet.shape)}")
    in_sisdr = si_sdr(wet, dry).mean().item()
    out_sisdr = si_sdr(out, dry).mean().item()
    check(out_sisdr > in_sisdr, f"the trained UMX dereverbs: {out_sisdr} <= {in_sisdr}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    cpu = copy.deepcopy(umx).cpu().sample(wet[:1].cpu())
    cpu_rel = max_rel(out[:1], cpu)
    check(cpu_rel <= BACKBONE_CPU_TOL, f"UMX card vs CPU {cpu_rel} <= {BACKBONE_CPU_TOL}")
    with tf32():
        tf32_rel = max_rel(umx.sample(wet[:1]), cpu)
    return {"ckpt": UMX_DIR, "effect": effect, "niter": 1, "batch": UMX_B,
            "samples": UMX_T, "load_s": load_s, "envelope_launches": launches,
            "input_si_sdr_db": in_sisdr, "output_si_sdr_db": out_sisdr,
            "cpu_rows": 1, "cpu_max_rel_err": cpu_rel, "cpu_tol": BACKBONE_CPU_TOL,
            "tf32_cpu_max_rel_err": tf32_rel,
            "sample_ms": wall_ms(lambda: umx.sample(wet)), "peak_allocated_gib": peak}


def dptnet_phase(seed: int, clips: torch.Tensor) -> dict:
    """DPTNet at the dptnet model config's full width with seeded weights:
    sample on the 8 demo clips x 262144, card against CPU on 16384
    samples, then RemovalTask steps on 2 x 262144 (a tanh distortion to
    remove), whose loss must fall over 3 steps on one batch."""
    dev = clips.device
    net = MODEL_CONFIGS["dptnet"]["network"]
    torch.manual_seed(seed)
    dpt = make_model("dptnet", sample_rate=SR, device=dev, **net)
    x = clips[:, None, :]
    torch.cuda.reset_peak_memory_stats()
    # ---- the DPTNet path: counts at 0 just before, read just after ----
    envelope.launches = 0
    y = dpt.sample(x)
    torch.cuda.synchronize()
    launches = envelope.launches
    # ---- end of the path ----
    check(y.shape == x.shape and bool(torch.isfinite(y).all()),
          f"DPTNet output finite, {tuple(x.shape)}")
    sample_peak = torch.cuda.max_memory_allocated() / 2**30
    sample_ms = wall_ms(lambda: dpt.sample(x))
    kernels = device_kernel_counts(lambda: dpt.sample(x))
    x0 = x[:1, :, :DPT_CPU_T].contiguous()
    cpu = copy.deepcopy(dpt).cpu().sample(x0.cpu())
    cpu_rel = max_rel(dpt.sample(x0), cpu)
    check(cpu_rel <= BACKBONE_CPU_TOL,
          f"DPTNet card vs CPU {cpu_rel} <= {BACKBONE_CPU_TOL}")
    with tf32():
        tf32_rel = max_rel(dpt.sample(x0), cpu)

    task = RemovalTask(dpt, max_steps=100)
    state = task.init_state()
    target = x[:DPT_TRAIN_B]
    batch = (torch.tanh(3.0 * target) / 3.0, target)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(DPT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = task.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite_metrics({k: v.item() for k, v in m.items()}, "DPTNet step")
        losses.append(m["train_loss"].item())
    check(losses[-1] < losses[0], f"DPTNet steps on one batch lower the loss: {losses}")
    frames = (x.shape[-1] - net["kernel_size"]) // net["stride"] + 1
    hop = net["chunk_size"] // 2
    return {"network": net, "batch": x.shape[0], "samples": x.shape[-1], "frames": frames,
            "chunks": (frames + 2 * net["chunk_size"] - net["chunk_size"]) // hop + 1,
            "envelope_launches": launches, "sample_ms": sample_ms,
            "sample_peak_allocated_gib": sample_peak,
            "sample_device_kernels": sum(kernels.values()),
            "attention_kernels": attention_kernels(kernels),
            "sdp_enabled": {"flash": torch.backends.cuda.flash_sdp_enabled(),
                            "mem_efficient": torch.backends.cuda.mem_efficient_sdp_enabled(),
                            "math": torch.backends.cuda.math_sdp_enabled()},
            "cpu_samples": DPT_CPU_T, "cpu_max_rel_err": cpu_rel,
            "cpu_tol": BACKBONE_CPU_TOL, "tf32_cpu_max_rel_err": tf32_rel,
            "train_batch": DPT_TRAIN_B,
            "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
            "losses": losses, "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}


@contextlib.contextmanager
def tf32():
    """TF32 switched on for matmuls and cuDNN, as PyTorch's defaults have
    it for cuDNN, and back off after (resolve_device switches it off)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def attention_kernels(counts: dict) -> dict:
    """The fused-attention and softmax kernels among a trace's launches by
    kernel name, their names cut to 100 characters: which SDPA backend
    ran."""
    rx = re.compile(r"fmha|flash|attention|softmax", re.IGNORECASE)
    out = collections.Counter()
    for name, n in counts.items():
        if rx.search(name):
            out[name[:100]] += n
    return dict(out)


@contextlib.contextmanager
def recorded_renders():
    """The labels (dry, wet) of every EffectChainRenderer.render_batch call
    made inside, on the host."""
    calls = []
    original = EffectChainRenderer.render_batch

    def recording(self, generator, x):
        out = original(self, generator, x)
        calls.append((out[2].cpu(), out[3].cpu()))
        return out

    EffectChainRenderer.render_batch = recording
    try:
        yield calls
    finally:
        EffectChainRenderer.render_batch = original


def train_default_phase(seed: int, logs: Path) -> dict:
    """python -m remfx_tpu_torch.train +exp=default (UMX, 0-5 removed
    effects, no shuffle) on the dynamic synthetic dataset at its batch and
    chunk (16 x 262144): fit with 2 steps and one batch each of
    validation and test, then 2 timed render + train steps."""
    cfg = train_cfg(DEFAULT_ARGS, seed, logs, f"trainer.max_steps={DEFAULT_STEPS}",
                    f"datamodule.train_chunks={TRAIN_B * DEFAULT_STEPS}",
                    "datamodule.val_chunks=1", "datamodule.test_chunks=1")
    dm = cfg["datamodule"]
    check(cfg["model"]["name"] == "umx" and dm["train_batch_size"] == TRAIN_B
          and dm["test_batch_size"] == 1 and cfg["chunk_size"] == T
          and cfg["num_removed_effects"] == [0, 5] and not cfg["shuffle_removed_effects"],
          "+exp=default trains UMX on 0-5 effects, not shuffled, at 16 x 262144")
    # ---- the default experiment's training path ----
    with recorded_renders() as renders:
        envelope.launches = 0
        state, test_metrics = fit(cfg)
        torch.cuda.synchronize()
        launches = envelope.launches
    # ---- end of the path ----
    finite_metrics(test_metrics, "+exp=default test")
    train_rows = [r for r in csv_rows(logs) if r.get("train_loss")]
    check(len(train_rows) == DEFAULT_STEPS, f"{DEFAULT_STEPS} train rows logged")
    finite_metrics({k: float(v) for r in train_rows for k, v in r.items()
                    if k.startswith("train_") and v}, "+exp=default train")
    with_comp = sum(bool((d[:, COMPRESSOR] + w[:, COMPRESSOR]).any()) for d, w in renders)
    # each render with a compressor row runs the compressor once (a redraw
    # runs it again); a render without one never launches the kernel
    check(launches >= with_comp and (launches > 0) == (with_comp > 0),
          f"envelope launches {launches} for {with_comp} renders with the compressor")

    task = build_task(cfg)
    tstate = task.init_state()
    ds = build_datamodule(train_cfg(DEFAULT_ARGS, seed, logs, "render_files=false",
                                    "datamodule.val_chunks=1",
                                    "datamodule.test_chunks=1")).train_dataset
    render_ms, step_ms, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(DEFAULT_STEPS):
        before = envelope.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ds.get_batch(np.arange(i * TRAIN_B, (i + 1) * TRAIN_B))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = task.train_step(tstate, (batch[0], batch[1]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        render_ms.append((t1 - t0) * 1e3)
        per_step.append(envelope.launches - before)
        finite_metrics({k: v.item() for k, v in m.items()}, "+exp=default timed step")
    return {"batch": TRAIN_B, "samples": T, "fit_steps": state.step,
            "renders": len(renders), "renders_with_compressor": with_comp,
            "fit_envelope_launches": launches, "envelope_launches_per_step": per_step,
            "train_loss": [float(r["train_loss"]) for r in train_rows],
            "test_metrics": test_metrics, "step_ms": step_ms, "render_ms": render_ms,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}


def _vendored_model(path: str) -> dict:
    return json.loads((ROOT / path / "hparams.json").read_text())["model"]


def torch_import_phase(chain, cfg: dict, tmp: Path) -> dict:
    """The trained phase's models written as .ckpt files in the reference's
    Lightning layout, then demo_detect's chain built again by build_chain
    from those files and the vendored models' configs: the labels and the
    removal of the demo clip equal the trained chain's bit for bit."""
    files, import_s = {}, {}
    for slot, w in chain.models.items():
        files[slot] = tmp / f"{slot}.ckpt"
        torch.save({"state_dict": {f"model.model.{k}": v.cpu()
                                   for k, v in w.module.state_dict().items()}}, files[slot])
    files["classifier"] = tmp / "classifier.ckpt"
    torch.save({"state_dict": {f"network.{k}": v.cpu()
                               for k, v in chain.classifier.state_dict().items()}},
               files["classifier"])
    for name, path in files.items():
        t0 = time.perf_counter()
        torch_import.import_torch_checkpoint(path)
        import_s[name] = time.perf_counter() - t0
    ckpt_cfg = copy.deepcopy(cfg)
    for slot, spec in ckpt_cfg["ckpts"].items():
        ckpt_cfg["ckpts"][slot] = {"model": _vendored_model(spec["ckpt_path"]),
                                   "ckpt_path": str(files[slot])}
    ckpt_cfg["classifier"] = _vendored_model(cfg["classifier_ckpt"])
    ckpt_cfg["classifier_ckpt"] = str(files["classifier"])
    dev = next(chain.classifier.parameters()).device
    t0 = time.perf_counter()
    again = build_chain(ckpt_cfg, None, device=dev)
    build_s = time.perf_counter() - t0
    check({k: (type(m.module), m.residual) for k, m in again.models.items()}
          == {k: (type(m.module), m.residual) for k, m in chain.models.items()},
          "the .ckpt chain has the trained chain's slots and wrappers")
    audio, _ = read_wav(ROOT / DEMO_IN)
    x = torch.from_numpy(audio)[None].to(dev)
    # ---- the .ckpt chain's path: counts at 0 just before, read just after ----
    envelope.launches = 0
    labels = again.detect(x)
    y, _ = again.remove(x, labels)
    torch.cuda.synchronize()
    launches = envelope.launches
    # ---- end of the path ----
    want_labels = chain.detect(x)
    want, _ = chain.remove(x, want_labels)
    check(torch.equal(labels, want_labels), "the .ckpt chain's labels equal the trained chain's")
    check(torch.equal(y, want), "the .ckpt chain's removal equals the trained chain's bit for bit")
    return {"files": {k: p.stat().st_size for k, p in files.items()},
            "import_s": import_s, "build_s": build_s, "envelope_launches": launches,
            "labels": labels[0].tolist(), "bit_equal": True}


# ------------------------------- the mixing channel, the phaser kernel, evaluation

PHASER_CPU_T = 16384  # the serial phaser's bit-for-bit check, 8 x 2 x 16384
PHASER_DWELL = {"rate_hz": 0.25, "depth": 0.6, "feedback": 0.6, "mix": 0.7}
CHANNEL_CPU_T = 65536  # samples of the channel's card-against-CPU row
CHANNEL_CPU_TOL = 1e-4  # x peak, as the synthesis path's
LUFS_CHANNEL_TOL = 0.1  # LU of the channel's -32 LUFS
SPLIT_CHAIN = 7  # the split phaser's dependent FMAs a sample, and a 7 x 7 matvec's
FP32_LATENCY_CYCLES = 4  # an fp32 multiply or add on Hopper
EVAL_N, EVAL_CHUNKS, EVAL_BATCH = "0,1", 16, 8
CLS_PT_ARGS = ["+exp=5-5_full_cls", "model=cls_panns_pt", "datamodule.synthetic=true",
               "datamodule.dataset_type=dynamic", f"datamodule.train_batch_size={CLS_B}"]
CLS_PT_CPU_ROWS = 4  # rows of the card-against-CPU step, CPU_T samples each


def stereo(clips: torch.Tensor) -> torch.Tensor:
    """(8, 2, 262144): each demo clip beside the next one."""
    return torch.stack([clips, clips.roll(1, dims=0)], dim=1).contiguous()


def sm_clock_ghz() -> float:
    """The card's largest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) / 1e3


# The phaser's trace in a process of its own, where it is the first thing
# traced: run from the repo's root with the generator's seed.
PHASER_TRACE = """
import json, sys
import torch
import chip_smoke as cs
dev = torch.device("cuda")
cs._build.build(cs._build.all_sources())
x2 = cs.stereo(torch.from_numpy(cs.demo_clips()).to(dev))
gen = torch.Generator().manual_seed(int(sys.argv[1]))
p = cs.phaser_fx.sample_params(gen, cs.B, cs.phaser_fx.DEFAULT_RANGES, device=dev)
a = cs.phaser_fx.coefficients(p, cs.T, cs.SR, dev)
fb, mix = p["feedback"].contiguous(), p["mix"].contiguous()
cs.phaser(x2, a, fb, mix)
print(json.dumps(cs.phaser_passes(x2, a, fb, mix)))
"""


def phaser_trace_apart(seed: int) -> dict:
    """``phaser_passes`` in a new process."""
    out = subprocess.run([sys.executable, "-c", PHASER_TRACE, str(seed)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def phaser_hard_batch(clips: torch.Tensor):
    """(8, 2, 262144) of the demo clips on the phaser's slowest poles (rate
    0.25 Hz, depth 0.6: the coefficient dwells below -0.993, poles above z =
    0.993, for about 52,000 samples from sample 118,000; feedback 0.6):
    rows 0-3 as they are, rows 4-5 a 0.1 s burst then digital silence, rows
    6-7 silent from sample 130,000, just before the dwell."""
    x = stereo(clips).clone()
    x[4:6, :, SR // 10:] = 0.0
    x[6:, :, 130000:] = 0.0
    p = {k: torch.full((B,), v, device=clips.device) for k, v in PHASER_DWELL.items()}
    p["centre_frequency_hz"] = torch.full((B,), 200.0, device=clips.device)
    return x, phaser_fx.coefficients(p, T, SR, clips.device), p["feedback"], p["mix"]


def row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over each row's peak."""
    peak = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return ((got - want).abs() / peak).max().item()


def phaser_passes(x, a, fb, mix, calls: int = 3) -> dict:
    """The split phaser's device kernels in a trace of the card over
    ``calls`` calls, between two copies (a trace can miss its first
    kernels): each kernel's device ms a call, by name."""
    out = collections.Counter()
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.add(0.0)
        for _ in range(calls):
            phaser(x, a, fb, mix)
        x.add(0.0)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "phaser" in e.key:
            name = next((k for k in ("maps", "scan", "apply") if f"phaser_{k}" in e.key), e.key)
            out[name] += e.self_device_time_total / 1e3 / e.count
    return dict(out)


def phaser_row(clips: torch.Tensor, gen: torch.Generator, seed: int) -> dict:
    """The phaser's two kernels against phaser_plain, run on the host from
    the same coefficient: the serial kernel bit for bit at 8 x 2 x 16384 and
    at the channel's shape, 8 x 2 x 262144; the split kernel (the default)
    within SPLIT_TOL of each row's peak there, on the demo clips and on the
    hard rows. Both timed at 8 x 1 and 8 x 2 x 262144: back-to-back calls
    by events ("ms", the serial kernel's "serial_ms" alike), the split
    kernel also by graph replays ("graph_ms")."""
    dev = clips.device
    x2 = stereo(clips)
    p = phaser_fx.sample_params(gen, B, phaser_fx.DEFAULT_RANGES, device=dev)
    a = phaser_fx.coefficients(p, T, SR, dev)
    fb, mix = p["feedback"].contiguous(), p["mix"].contiguous()
    hard = phaser_hard_batch(clips)

    def host(v):
        return v.cpu()

    xs = x2[..., :PHASER_CPU_T].contiguous()
    a_s = a[:, :PHASER_CPU_T].contiguous()
    short = phaser_serial(xs, a_s, fb, mix)
    check(torch.equal(short.cpu(), phaser_plain(*map(host, (xs, a_s, fb, mix)))),
          f"serial phaser kernel equals phaser_plain bit for bit at 8 x 2 x {PHASER_CPU_T}")
    got = {"demo": phaser(x2, a, fb, mix), "hard": phaser(*hard)}
    serial = {"demo": phaser_serial(x2, a, fb, mix), "hard": phaser_serial(*hard)}
    torch.cuda.synchronize()
    # one host loop for both batches: the loop's time is per step, not per row
    t0 = time.perf_counter()
    both = phaser_plain(*(torch.cat([host(u), host(v)]) for u, v in
                          zip((x2, a, fb, mix), hard)))
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = {"demo": both[:B], "hard": both[B:]}
    errs = {}
    for k in ("demo", "hard"):
        check(bool(torch.isfinite(got[k]).all()), f"split phaser finite ({k})")
        check(torch.equal(serial[k].cpu(), want[k]),
              f"serial phaser kernel equals phaser_plain bit for bit at 8 x 2 x {T} ({k})")
        errs[k] = row_rel(got[k].cpu(), want[k])
        check(errs[k] <= SPLIT_TOL, f"split phaser within {SPLIT_TOL} of each row's "
              f"peak of phaser_plain ({k}): {errs[k]}")
    x1 = clips[:, None, :].contiguous()
    # after the host loop the card's clocks take a while to rise, and the
    # first timings read slow
    for _ in range(3):
        time_kernel(lambda: phaser(x2, a, fb, mix))
    ms = {"8x1": time_kernel(lambda: phaser(x1, a, fb, mix)),
          "8x2": time_kernel(lambda: phaser(x2, a, fb, mix))}
    # back-to-back calls from the host can leave the card waiting for the
    # next launch (three kernels a call, each a few tens of microseconds),
    # so the card's own time is read from graph replays too
    replayed = {"8x1": graph_ms(lambda: phaser(x1, a, fb, mix)),
                "8x2": graph_ms(lambda: phaser(x2, a, fb, mix))}
    serial_ms = {"8x1": time_kernel(lambda: phaser_serial(x1, a, fb, mix), rounds=3, calls=3),
                 "8x2": time_kernel(lambda: phaser_serial(x2, a, fb, mix), rounds=3, calls=3)}
    # where this process's traces miss the phaser's kernels (whole runs on
    # the card have seen that), a new process traces them
    for traces in range(1, 5):
        passes = (phaser_passes(x2, a, fb, mix) if traces <= 3
                  else phaser_trace_apart(seed))
        if len(passes) == 3:
            break
    check(len(passes) == 3, f"the profiler saw the phaser's 3 device kernels: {passes}")
    rows, channels, steps = x2.shape
    n_bytes = (2 * rows * channels * steps + rows * steps + 2 * rows) * 4
    n_ops = 29 * rows * channels * steps  # per sample: 2 + 6 x 4 + 3 roundings
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    ghz = sm_clock_ghz()
    groups = -(-steps // (32 * PHASER_CHUNK))
    # the split design's chain: passes 1 and 3 a chunk each, pass 1's warp
    # scan (5 rounds), pass 2 a 7 x 7 product a group
    split_cycles = ((2 * PHASER_CHUNK + 5 + groups) * SPLIT_CHAIN * FP32_LATENCY_CYCLES)
    return {
        "name": "phaser",
        "kind": "hand kernel, not a TPU kernel",
        "route": "cuda",
        "source": "remfx_tpu_torch/csrc/phaser.cu",
        "replaces": "remfx_tpu/fx/phaser.py:94",
        "shape": [rows, channels, steps],
        "chunk": PHASER_CHUNK,
        "device_kernels_per_call": len(passes),
        "traces": traces,  # 4: in a new process
        "pass_device_ms": passes,
        "max_abs_err": (got["demo"].cpu() - want["demo"]).abs().max().item(),
        "max_rel_err": errs,  # of each row's peak, demo clips and hard rows
        "tolerance": SPLIT_TOL,
        "serial_equal": True,
        "serial_equal_samples": [PHASER_CPU_T, steps],
        "ms": ms["8x2"],
        "kernel_ms": ms,
        "graph_ms": replayed,
        "serial_ms": serial_ms,
        "plain_ms": plain_ms,
        "plain_device": "cpu",
        "plain_rows": 2 * rows,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "latency_bound_ms": split_cycles / (ghz * 1e9) * 1e3,
        "sm_clock_max_ghz": ghz,
        "library_ms": None,
    }


def loud_ok(y: torch.Tensor, what: str) -> float:
    lufs = integrated_loudness(y, SR)
    err = (lufs + 32.0).abs().max().item()
    check(err <= LUFS_CHANNEL_TOL, f"{what}: every row at -32 LUFS within "
          f"{LUFS_CHANNEL_TOL} LU: {err}")
    return err


def channel_phase(clips: torch.Tensor, seed: int) -> dict:
    """RandomAudioEffectsChannel on the 8 demo clips as stereo x 262144: every
    stage forced on (all ten probabilities 1), then the defaults; sox_reverb
    alone at max_room_scale 100; one row card against CPU."""
    dev = clips.device
    x = stereo(clips)
    forced = RandomAudioEffectsChannel(SR, device=dev, **{
        f"{n}_prob": 1.0 for n in RandomAudioEffectsChannel.DEFAULT_PROBS})
    apply, params = forced.sample(torch.Generator().manual_seed(seed), B, 2)
    check(all(bool(v.all()) for v in apply.values()), "every stage drawn for every row")
    # ---- the channel's path: counts at 0 just before, read just after ----
    phaser.launches = 0
    envelope.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = forced.render_batch(x, apply, params)
    torch.cuda.synchronize()
    forced_ms = (time.perf_counter() - t0) * 1e3
    launches = {"phaser": phaser.launches, "envelope": envelope.launches}
    # ---- end of the channel's path ----
    check(launches["phaser"] == 1, f"one phaser launch a forced channel call: {launches}")
    check(launches["envelope"] == 3, "the compressor once and the limiter twice "
          f"launched the envelope kernel: {launches}")
    check(y.shape == x.shape and bool(torch.isfinite(y).all()),
          "forced channel output finite, (8, 2, 262144)")
    forced_lufs = loud_ok(y, "forced channel")
    forced_wall = wall_ms(lambda: forced.render_batch(x, apply, params), rounds=2)

    default = RandomAudioEffectsChannel(SR, device=dev)
    d_apply, d_params = default.sample(torch.Generator().manual_seed(seed), B, 2)
    phaser.launches = 0
    envelope.launches = 0
    yd = default.render_batch(x, d_apply, d_params)
    torch.cuda.synchronize()
    d_launches = {"phaser": phaser.launches, "envelope": envelope.launches}
    check(d_launches["phaser"] == int(bool(d_apply["phaser"].any())),
          f"the phaser launched once if a row drew it: {d_launches}")
    check(yd.shape == x.shape and bool(torch.isfinite(yd).all()),
          "default channel output finite")
    default_lufs = loud_ok(yd, "default channel")
    default_ms = wall_ms(lambda: default.render_batch(x, d_apply, d_params), rounds=2)

    sox = make_effect("sox_reverb", SR, device=dev)
    check(sox.ranges["max_room_scale"] == 100.0, "sox_reverb at max_room_scale 100")
    n_fft = sox_reverb.fft_size(T, sox.ranges, SR)
    check(n_fft == 2 ** 21, f"sox_reverb n_fft {n_fft} at 262144 samples")
    sp = sox.sample_params(torch.Generator().manual_seed(seed), B)
    torch.cuda.reset_peak_memory_stats()
    ys = sox.render_batch(x, sp)
    torch.cuda.synchronize()
    sox_peak = torch.cuda.max_memory_allocated() / 2**30
    check(ys.shape == x.shape and bool(torch.isfinite(ys).all()), "sox_reverb finite")
    sox_ms = wall_ms(lambda: sox.render_batch(x, sp))

    # one row, card against CPU, every stage on, the same parameters
    cpu = RandomAudioEffectsChannel(SR, device="cpu", **{
        f"{n}_prob": 1.0 for n in RandomAudioEffectsChannel.DEFAULT_PROBS})
    one = {n: v[:1] for n, v in apply.items()}
    p1 = {n: {k: v[:1] for k, v in p.items()} for n, p in params.items()}
    xr = x[:1, :, :CHANNEL_CPU_T].contiguous()
    card = forced.render_batch(xr, one, p1)
    host = cpu.render_batch(xr.cpu(), one,
                            {n: {k: v.cpu() for k, v in p.items()} for n, p in p1.items()})
    cpu_err = max_rel(card, host)
    check(cpu_err <= CHANNEL_CPU_TOL, f"channel card vs CPU {cpu_err} <= {CHANNEL_CPU_TOL}")
    return {"shape": list(x.shape), "launches": launches, "forced_first_ms": forced_ms,
            "forced_ms": forced_wall, "forced_lufs_max_err": forced_lufs,
            "default_drawn": {n: int(v.sum()) for n, v in d_apply.items()},
            "default_launches": d_launches, "default_ms": default_ms,
            "default_lufs_max_err": default_lufs,
            "audio_s_per_s_forced": B * T / SR / (forced_wall / 1e3),
            "sox_reverb": {"n_fft": n_fft, "ms": sox_ms, "peak_allocated_gib": sox_peak},
            "cpu_samples": CHANNEL_CPU_T, "cpu_max_rel_err": cpu_err}


def generate_dataset_phase(tmp: Path) -> dict:
    """python -m remfx_tpu_torch.cli.generate_dataset +exp=distortion on the
    card: 2 train, 1 validation and 1 test chunk of 262144 samples."""
    root = tmp / "generated"
    t0 = time.perf_counter()
    generate_dataset.main(["+exp=distortion", "datamodule.synthetic=true",
                           "datamodule.train_chunks=2", "datamodule.val_chunks=1",
                           "datamodule.test_chunks=1", "datamodule.render_batch_size=2",
                           f"render_root={root}"])
    seconds = time.perf_counter() - t0
    dirs = sorted(p.parent for p in root.rglob("input.wav"))
    check(len(dirs) == 4, f"4 rendered chunks, got {len(dirs)}")
    for d in dirs:
        check({p.name for p in d.iterdir()} == {"input.wav", "target.wav",
                                                "dry_effects.pt", "wet_effects.pt"},
              f"{d} holds the reference's four files")
        x, sr = read_wav(d / "input.wav")
        check(sr == SR and x.shape == (1, T) and bool(np.isfinite(x).all()),
              f"{d}/input.wav: 48 kHz, 262144 samples, finite")
    return {"chunks": len(dirs), "splits": sorted({d.parent.name for d in dirs}),
            "seconds": seconds}


def eval_matrix_argv(tmp: Path, root: Path = ROOT) -> tuple[list, str]:
    """The CLI's flags at full width from the vendored checkpoints of the
    checkout (trained_dirs), and the compressor slot's weights: "trained"
    where HDemucs' directory is there, "seeded" where it is not."""
    dirs, slots = trained_dirs(root)
    argv = ["--n", EVAL_N, "--variants", "oracle,detect,all",
            "--test-chunks", str(EVAL_CHUNKS), "--batch", str(EVAL_BATCH),
            "--root", str(tmp / "data"), "--out", str(tmp / "out"),
            "--classifier", "ckpts/classifier_cnn14_r5"]
    for name, slot in zip(dirs[1:], slots):
        argv += ["--ckpt", f"{slot}=ckpts/{name}"]
    return argv, "trained" if COMPRESSOR_DIR in dirs else "seeded"


def eval_matrix_phase(tmp: Path) -> dict:
    """python -m remfx_tpu_torch.cli.eval_matrix on the card: oracle, detect
    and all at N = 0 and 1 over 16 rendered chunks of 262144 samples, batch
    8, the trained slots and classifier; then a second sweep that must skip
    every cell."""
    argv, compressor = eval_matrix_argv(tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    env = dict(os.environ)
    env.pop("REMFX_ALLOW_RANDOM_CKPT", None)
    if compressor == "seeded":
        env["REMFX_ALLOW_RANDOM_CKPT"] = "1"  # the compressor slot alone is absent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "remfx_tpu_torch.cli.eval_matrix", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"eval_matrix exits 0: {proc.stderr[-3000:]}")
    rows = json.loads((tmp / "out" / "eval_matrix.json").read_text())
    cells = {(r["variant"], r["n"]): r for r in rows}
    check(sorted(cells) == sorted((v, n) for v in ("oracle", "detect", "all")
                                  for n in (0, 1)), f"six cells: {sorted(cells)}")
    metrics = ("test_loss", "test_SISDR", "test_STFT", "Input_SISDR", "Input_STFT")
    for key, r in cells.items():
        finite_metrics({k: r[k] for k in metrics}, f"eval_matrix {key}")
        check(r["examples"] == EVAL_CHUNKS, f"{key}: {EVAL_CHUNKS} chunks")
    check(cells[("oracle", 0)]["test_SISDR"] > 80.0,
          f"oracle at N = 0 is the identity: {cells[('oracle', 0)]['test_SISDR']} dB")
    check(cells[("detect", 1)]["test_SISDR"] > cells[("all", 1)]["test_SISDR"],
          "detect beats all at N = 1")
    table = (tmp / "out" / "eval_matrix.md").read_text()
    out = io.StringIO()
    with contextlib.chdir(ROOT), contextlib.redirect_stdout(out):
        again = eval_matrix.main(argv)
    check(again == rows and out.getvalue().count("skip ") == len(rows),
          "a second sweep skips every cell")
    print(table, end="", flush=True)
    return {"compressor": compressor, "cells": len(rows), "seconds": seconds,
            "card_memory_used_before": smi,
            "smoke_reserved_gib_before": torch.cuda.memory_reserved() / 2**30,
            "wall_s": {f"{r['variant']}:{r['n']}": r["wall_s"] for r in rows},
            "rows": rows, "second_sweep_skipped": len(rows)}


def classifier_step(net, batch, lr: float) -> tuple[float, list]:
    task = ClassifierTask(net, lr=lr, loss_type="ce", sample_rate=SR)
    state = task.init_state()
    _, m = task.train_step(state, batch)
    return m["train_loss"].item(), [p.detach().cpu() for p in net.parameters()]


def train_cls_pt_phase(seed: int, logs: Path, clips: torch.Tensor) -> dict:
    """+exp=5-5_full_cls model=cls_panns_pt (the frozen Cnn14 trunk at
    32 kHz and a trainable head) on the card through fit, at train_cls's
    32 x 262144 for CLS_STEPS steps; the trunk unchanged and the head moved;
    timed steps; one step card against CPU."""
    cfg = train_cfg(CLS_PT_ARGS, seed, logs, f"trainer.max_steps={CLS_STEPS}",
                    f"datamodule.train_chunks={CLS_B * CLS_STEPS}",
                    f"datamodule.val_chunks={CLS_B}", f"datamodule.test_chunks={CLS_B}")
    m = cfg["model"]
    check(m["name"] == "embedding" and m["network"]["kind"] == "panns"
          and m["loss_type"] == "ce" and cfg["datamodule"]["train_batch_size"] == CLS_B,
          "cls_panns_pt: the PANNs embedding classifier, CE loss, batch 32")
    head0 = {k: v.clone() for k, v in build_task(cfg).network.state_dict().items()}
    # ---- the frozen-embedding classifier's training path ----
    state, test_metrics = fit(cfg)
    torch.cuda.synchronize()
    # ---- end of the path ----
    finite_metrics(test_metrics, "cls_panns_pt test")
    train_rows = [r for r in csv_rows(logs) if r.get("train_loss")]
    check(len(train_rows) == CLS_STEPS, f"{CLS_STEPS} cls_panns_pt train rows")
    finite_metrics({k: float(v) for r in train_rows for k, v in r.items()
                    if k.startswith("train_") and v}, "cls_panns_pt train")
    net = state.model
    head = net.state_dict()
    check(sorted(head) == sorted(head0) and all(k.startswith("proj.") for k in head),
          "the trainable parameters are the head's")
    moved = max((head[k] - v).abs().max().item() for k, v in head0.items())
    check(moved > 0.0, "the head moved")
    fresh = make_panns_embed_fn(device=DEVICE).trunk.state_dict()
    check(all(torch.equal(v, fresh[k]) for k, v in net.embed_fn.trunk.state_dict().items()),
          "the trunk is unchanged bit for bit")
    saved = read_state(str(next(logs.rglob("best"))), device="cpu")
    check(sorted(saved["model"]) == sorted(head0), "the checkpoint holds the head only")

    gen = torch.Generator().manual_seed(seed)
    xb = torch.cat([clips] * (CLS_B // B))[:, None, :]
    labels = (torch.rand(CLS_B, len(ALL_EFFECTS), generator=gen) < 0.5).float().to(DEVICE)
    task = ClassifierTask(net, lr=m["lr"], loss_type="ce", sample_rate=SR)
    tstate = task.init_state()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sm = task.train_step(tstate, (xb, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite_metrics({k: v.item() for k, v in sm.items()}, "cls_panns_pt timed step")
    peak = torch.cuda.max_memory_allocated() / 2**30

    trunk_cpu = {k: v.cpu() for k, v in net.embed_fn.trunk.state_dict().items()}
    x0 = xb[:CLS_PT_CPU_ROWS, :, :CPU_T]
    y0 = labels[:CLS_PT_CPU_ROWS]
    out = {}
    for where, dev in (("card", DEVICE), ("cpu", "cpu")):
        n = make_embedding_classifier("panns", len(ALL_EFFECTS), SR,
                                      embed_state_dict=trunk_cpu, device=dev)
        n.load_state_dict({k: v.cpu() for k, v in head.items()})
        out[where] = classifier_step(n, (x0.to(dev), y0.to(dev)), m["lr"])
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    param_err = max((a - b).abs().max().item() for a, b in zip(out["card"][1], out["cpu"][1]))
    check(loss_rel <= TRAIN_CPU_TOL, f"cls_panns_pt step loss card vs CPU {loss_rel}")
    # Adam moves each parameter by about lr a step
    check(param_err <= 2.05 * m["lr"], f"cls_panns_pt step parameters card vs CPU {param_err}")
    return {"batch": CLS_B, "samples": T, "steps": state.step,
            "train_loss": [float(r["train_loss"]) for r in train_rows],
            "test_metrics": test_metrics, "head_parameters": sum(v.numel() for v in head.values()),
            "head_max_move": moved, "trunk_unchanged": True, "step_ms": step_ms,
            "peak_allocated_gib": peak,
            "cpu_step": {"rows": CLS_PT_CPU_ROWS, "samples": CPU_T,
                         "loss_cpu": out["cpu"][0], "loss_card": out["card"][0],
                         "loss_rel_err": loss_rel, "param_max_abs_err": param_err}}


# -------------------------------------------------------------- multi-device

PAR_STEPS = 2  # fit steps of the data-parallel run and of its one-process twin
PAR_LOSS_TOL = 1e-5  # train loss per step, relative
LR = 1e-4  # compression_aug's, and the tcn experiment's
# The parameters after the steps, ranks against one process, in units of
# lr: Adam moves an element by about lr whatever its gradient's size, so
# where the ranks' sums of halves round a near-zero gradient to the other
# sign the element moves up to 2 lr the other way on that step. The rule
# of tests/test_torch_train.py for the Mini-DCUNet: none beyond 2.05 lr a
# step, at most 0.1 % of the elements beyond 0.5 lr. Adam's first moment,
# the averaged gradient itself, within PAR_MOMENT_TOL of the largest
# moment: a wrong average (a sum, or one rank's) is off by a factor of
# the ranks.
PAR_SHARE, PAR_MOMENT_TOL = 1e-3, 1e-2
PAR_TIMED = 3  # timed render + train steps in each rank
JOIN_S = 900  # deadline of a launch's join
REMAT_B, REMAT_BF16_B = 2, 16  # the tcn experiment's network, remat off / on, at 262144
REMAT_TOL = 1e-6  # gradients, relative to each parameter's largest
PIPE_WINDOWS = 4
TP_B, TP_T = 8, 131072  # the dp x tp step's batch


def ddp_rank(cfg: dict, timed: int) -> dict:
    """One rank of the data-parallel run (``launch.spawn`` runs it in each
    process of the NCCL group): ``fit`` through the port's per-rank
    worker, then ``timed`` renders of the one device's batch and train
    steps on this rank's rows, each timed, with the envelope's launches."""
    import torch.distributed as dist

    from remfx_tpu_torch.parallel import batch_rows
    from remfx_tpu_torch.train.loop import _shard_state, build_mesh, device_of, rank_fit

    dev = device_of(cfg)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(dev)}
    envelope.launches = phaser.launches = 0
    out["test_metrics"] = rank_fit(cfg)
    torch.cuda.synchronize()
    out["fit_envelope_launches"] = envelope.launches
    out["fit_phaser_launches"] = phaser.launches
    mesh = build_mesh(cfg)
    task = build_task(cfg, dev)
    state = _shard_state(task, task.init_state(), mesh)
    data = build_datamodule({**cfg, "render_files": False}, dev)
    b = cfg["datamodule"]["train_batch_size"]
    render_ms, step_ms, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(timed):
        before = envelope.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = data.train_dataset.get_batch(np.arange(i * b, (i + 1) * b))
        rows = batch_rows(b, mesh)
        x, y = (rows.take(t) for t in batch[:2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = task.train_step(state, (x, y), rows)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        render_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        per_step.append(envelope.launches - before)
    out.update(rows=[rows.start, rows.stop], render_ms=render_ms, step_ms=step_ms,
               envelope_launches_per_step=per_step,
               peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def compare_states(got: dict, want: dict, steps: int, what: str) -> dict:
    """Parameters (``model``) and Adam's first moments (``optimizer``) of
    two ``TrainState.state_dict()``s, ranks' against one process'."""
    check(set(got["model"]) == set(want["model"]), f"{what}: the module's own names")
    errs = torch.cat([(got["model"][k].float() - v.float()).abs().flatten()
                      for k, v in want["model"].items() if v.is_floating_point()])
    # over the largest moment of all: a parameter whose gradient is zero
    # but for rounding (a bias before a normalisation) has no scale of its own
    moments = want["optimizer"]["state"].items()
    moment = (max((got["optimizer"]["state"][i]["exp_avg"] - st["exp_avg"]).abs().max().item()
                  for i, st in moments)
              / max(st["exp_avg"].abs().max().item() for _, st in moments))
    out = {"param_max_abs_err_lr": errs.max().item() / LR,
           "param_share_beyond_0.2lr": (errs > 0.2 * LR).float().mean().item(),
           "param_share_beyond_0.5lr": (errs > 0.5 * LR).float().mean().item(),
           "exp_avg_max_rel_err": moment}
    check(out["param_max_abs_err_lr"] <= 2.05 * steps
          and out["param_share_beyond_0.5lr"] <= PAR_SHARE, f"{what} parameters: {out}")
    check(moment <= PAR_MOMENT_TOL, f"{what} Adam first moments: {moment}")
    return out


def last_state(logs: Path) -> dict:
    return read_state(str(find_latest_run(str(logs)) / "last"))


def ddp_part(seed: int, tmp: Path, n: int) -> dict:
    """compression_aug on ``n`` ranks through launch.spawn, then the same
    fit in this process: the train loss per step and the parameters."""
    from remfx_tpu_torch.parallel import launch

    def cfg_of(tag, devices):
        return train_cfg(TRAIN_ARGS, seed, tmp / tag, f"trainer.max_steps={PAR_STEPS}",
                         f"trainer.devices={devices}",
                         f"datamodule.train_chunks={TRAIN_B * PAR_STEPS}",
                         f"datamodule.val_chunks={TRAIN_B}",
                         f"datamodule.test_chunks={TRAIN_B}",
                         f"datamodule.test_batch_size={TRAIN_B}")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(ddp_rank, n, cfg_of("ddp", n), PAR_TIMED, device_type="cuda",
                         timeout=JOIN_S)
    ddp_s = time.perf_counter() - t0
    for r in ranks:
        check(r["backend"] == "nccl" and r["device"].startswith("cuda"),
              f"rank {r['rank']}: backend {r['backend']} on {r['device']}")
        check(r["envelope_launches_per_step"] == [1] * PAR_TIMED,
              f"rank {r['rank']}: one envelope launch a step: {r['envelope_launches_per_step']}")
        finite_metrics(r["test_metrics"], f"rank {r['rank']} test")
    t0 = time.perf_counter()
    _, one_metrics = fit(cfg_of("one", 1))
    one_s = time.perf_counter() - t0
    losses = {tag: [float(row["train_loss"]) for row in csv_rows(tmp / tag)
                    if row.get("train_loss")] for tag in ("ddp", "one")}
    check(len(losses["ddp"]) == len(losses["one"]) == PAR_STEPS,
          f"{PAR_STEPS} train rows each: {losses}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["ddp"], losses["one"]))
    check(loss_rel <= PAR_LOSS_TOL, f"train loss per step, {n} ranks against one: {loss_rel}")
    states = compare_states(last_state(tmp / "ddp"), last_state(tmp / "one"), PAR_STEPS,
                            f"{n} ranks against one")
    return {"ranks": ranks, "fit_s": ddp_s, "one_process_fit_s": one_s,
            "train_loss": losses, "loss_rel_err": loss_rel, **states,
            "one_process_test_metrics": one_metrics,
            "envelope_launches": sum(r["fit_envelope_launches"] for r in ranks),
            "phaser_launches": sum(r["fit_phaser_launches"] for r in ranks)}


def tcn_remat_part(seed: int, dev) -> dict:
    """The tcn experiment's network (20 x 256, kernel 7): remat on against
    off at 2 x 262144 fp32 (the gradients of one forward and backward, and
    the peaks), then one bf16-mixed RemovalTask step with remat at 16 x
    262144 (its first: cuDNN's bf16 plans are made in it)."""
    net = MODEL_CONFIGS["tcn"]["network"]
    torch.manual_seed(seed)
    plain = make_tcn(sample_rate=SR, device=dev, remat=False, **net)
    remat = copy.deepcopy(plain)
    remat.module.remat = True
    gen = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn(REMAT_BF16_B, 1, T, generator=gen)).to(dev)
    y = 0.5 * torch.tanh(2 * x)
    out = {}
    grads = {}
    for name, w in (("off", plain), ("on", remat)):
        w.train().zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the gradient of a fixed ramp's product with the output: the
        # removal loss's STFT pads by reflection, whose backward on the
        # card adds with atomics and moves the deep gradients in their last digits
        # from one run to the next, remat or not
        yo = w(x[:REMAT_B])
        (yo * torch.linspace(-1, 1, yo.shape[-1], device=dev)).sum().backward()
        torch.cuda.synchronize()
        out[f"fp32_{name}"] = {"ms": (time.perf_counter() - t0) * 1e3,
                               "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
        grads[name] = [p.grad for p in w.parameters()]
        del yo
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(grads["on"], grads["off"]))
    check(rel <= REMAT_TOL, f"TCN gradients, remat on against off: {rel}")
    check(out["fp32_on"]["peak_allocated_gib"] < out["fp32_off"]["peak_allocated_gib"],
          "remat lowers the peak")
    del plain, grads
    remat.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    task = RemovalTask(remat, max_steps=100, precision="bf16-mixed")
    state = task.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # cuDNN's deterministic algorithms (on for the rest of the smoke) take
    # a direct bf16 dgrad kernel for these dilated convolutions, about 4 x
    # slower: training chooses freely
    deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, False
    try:
        t0 = time.perf_counter()
        _, m = task.train_step(state, (x, y))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.deterministic = deterministic
    finite_metrics({k: v.item() for k, v in m.items()}, "TCN bf16 remat step")
    out["bf16_remat_step"] = {"batch": REMAT_BF16_B, "samples": T, "step_ms": step_ms,
                              "cudnn_deterministic": False,
                              "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "train_loss": m["train_loss"].item()}
    out.update(grad_rel_err=rel, grads_bit_equal=rel == 0.0,
               receptive_field=remat.module.compute_receptive_field(),
               parameters=sum(p.numel() for p in remat.parameters()))
    return out


def pipeline_part(seed: int, clips: torch.Tensor) -> dict:
    """PipelineChain over every card (the seeded five-slot chain of
    build_slots, classifier first) on 4 windows of the demo batch: each
    window equal to ChainInference.run bit for bit; the wall time of the
    pipelined windows beside 4 sequential run calls."""
    from remfx_tpu_torch.chain.pipeline import PipelineChain

    dev = torch.device("cuda", 0)
    torch.manual_seed(seed)
    cls, slots = build_slots(dev)
    chain = ChainInference(slots, SR, classifier=cls)
    windows = [torch.roll(clips, k * T // PIPE_WINDOWS, dims=-1)[:, None, :].contiguous()
               for k in range(PIPE_WINDOWS)]
    pipe = PipelineChain(chain)
    pipe(windows[:1])  # warm-up of every stage's device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = pipe(windows)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    pipe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    runs = [chain.run(w) for w in windows]
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    for i, ((y, lab), (y_run, lab_run)) in enumerate(zip(outs, runs)):
        check(torch.equal(lab.to(dev), lab_run), f"window {i}: the pipeline's labels equal run's")
        check(torch.equal(y.to(dev), y_run), f"window {i}: the pipeline equals run bit for bit")
    return {"windows": PIPE_WINDOWS, "rows": B, "samples": T,
            "stage_device": {k: str(v) for k, v in pipe.stage_device.items()},
            "pipeline_ms": pipe_ms, "sequential_run_ms": run_ms,
            "speedup": run_ms / pipe_ms, "bit_equal": True}


def tensor_parallel_part(seed: int, n: int) -> dict:
    """A dp x tp (FSDP2) step of the tcn experiment's network on ``n`` cards
    against the one-process step on the card."""
    from remfx_tpu_torch.parallel import launch
    from remfx_tpu_torch.parallel.steps import removal_steps

    net = dict(MODEL_CONFIGS["tcn"]["network"])
    torch.manual_seed(seed)
    sd = {k: v.numpy() for k, v in make_tcn(sample_rate=SR, device="cpu", **net)
          .module.state_dict().items()}
    gen = np.random.default_rng(seed)
    x = (0.3 * gen.standard_normal((TP_B, 1, TP_T))).astype(np.float32)
    y = (0.5 * np.tanh(2 * x)).astype(np.float32)
    tp = 2
    args = ("tcn", net, sd, x, y, 1, tp, "32", "cuda")
    t0 = time.perf_counter()
    ranks = launch.spawn(removal_steps, n - n % tp, *args, device_type="cuda",
                         timeout=JOIN_S)
    spawn_s = time.perf_counter() - t0
    one = removal_steps("tcn", net, sd, x, y, 1, 1, "32", "cuda")
    got, want = ranks[0]["losses"][0], one["losses"][0]
    loss_rel = abs(got - want) / abs(want)
    check(loss_rel <= PAR_LOSS_TOL, f"dp x tp loss against one process: {loss_rel}")
    check(all(r["sharded"] for r in ranks), "the ranks' parameters are DTensors")
    states = compare_states(*({"model": {k: torch.from_numpy(v) for k, v in r["state_dict"].items()},
                               "optimizer": {"state": {i: {"exp_avg": torch.from_numpy(m)}
                                                       for i, m in enumerate(r["exp_avg"])}}}
                              for r in (ranks[0], one)), 1, "dp x tp against one process")
    return {"mesh": ranks[0]["mesh"], "batch": TP_B, "samples": TP_T, "seconds": spawn_s,
            "loss": got, "loss_rel_err": loss_rel, **states}


SEQ_WINDOWS = 4  # the windows that 4 ranks of shard_time would hold
SEQ_TOL = 1e-5  # x the output's RMS: a halo plan against the whole file


def timed_ms(fn):
    """(fn(), its wall ms), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def plan_of(wrapper) -> dict:
    plan = time_plan(wrapper)
    if isinstance(plan, GatherPlan):
        return {"plan": "gather", "why": plan.why}
    return {"plan": "halo", "left": plan.left, "right": plan.right, "align": plan.align}


def plan_windows(slots: dict, cls, x: torch.Tensor) -> tuple[dict, dict]:
    """Every plan's windows on this card against the whole file: for each
    removal backbone, the SEQ_WINDOWS windows its plan gives the ranks of
    shard_time, each through span_sample, the owned outputs joined; a halo
    plan within SEQ_TOL x the whole output's RMS, a gather plan bit for
    bit. -> (per slot its plan, errors and times; the whole outputs)."""
    out, wholes = {"Cnn14 (classifier)": plan_of(cls)}, {}
    check(isinstance(time_plan(cls), GatherPlan), "the classifier's plan is the gather")
    for name, w in slots.items():
        plan = time_plan(w)
        whole, whole_ms = timed_ms(lambda: w.sample(x))
        got, windows_ms = timed_ms(lambda: sample_windows(w, plan, x, SEQ_WINDOWS))
        check(got.shape == whole.shape, f"{name}: windows give {tuple(got.shape)}")
        err = (got - whole).abs().max().item()
        row = {**plan_of(w), "max_abs_err": err, "rel_rms_err": err / rms(whole),
               "bit_equal": torch.equal(got, whole), "whole_ms": whole_ms,
               "windows_ms": windows_ms, "length_out": whole.shape[-1]}
        if isinstance(plan, GatherPlan):
            check(row["bit_equal"], f"{name}: the gather plan's windows bit for bit")
        else:
            check(row["rel_rms_err"] <= SEQ_TOL,
                  f"{name}: the halo plan's windows {row['rel_rms_err']} x RMS <= {SEQ_TOL}")
        out[name], wholes[name] = row, whole
    return out, wholes


def sequence_rank(seed: int) -> dict:
    """One rank of the time-sharded runs (``launch.spawn`` runs it in each
    process of the NCCL group): the seeded five-slot chain of build_slots
    and the joined file split in time over every rank; sample_time_sharded
    of the TCN and of a DCUNet, run_time_sharded with every label on and
    with detection, each timed after one warm-up pass, and gathered. Rank
    0 returns the gathered outputs."""
    import torch.distributed as dist

    from remfx_tpu_torch.parallel import gather_time, make_mesh, shard_time
    from remfx_tpu_torch.parallel.sequence import run_time_sharded, sample_time_sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    envelope.launches = phaser.launches = 0
    torch.manual_seed(seed)
    cls, slots = build_slots(dev)
    oracle_chain = ChainInference(slots, SR)
    detect_chain = ChainInference(slots, SR, classifier=cls)
    x = torch.from_numpy(joined_clips()).to(dev)[None]
    ones = torch.ones(1, len(ALL_EFFECTS), device=dev)
    shard = shard_time(x, make_mesh())
    run_time_sharded(oracle_chain, shard, ones)  # warm-up: every model's first pass
    run_time_sharded(detect_chain, shard)
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        dist.barrier()
        return timed_ms(fn)

    tcn, dcunet = slots["RandomPedalboardDistortion"], slots["RandomPedalboardReverb"]
    y_tcn, tcn_ms = timed(lambda: sample_time_sharded(tcn, shard))
    y_dcunet, dcunet_ms = timed(lambda: sample_time_sharded(dcunet, shard))
    (y_oracle, _), oracle_ms = timed(lambda: run_time_sharded(oracle_chain, shard, ones))
    (y_detect, labels), detect_ms = timed(lambda: run_time_sharded(detect_chain, shard))
    outs = {k: gather_time(y).cpu().numpy() for k, y in (
        ("tcn", y_tcn), ("dcunet", y_dcunet), ("oracle", y_oracle), ("detect", y_detect))}
    torch.cuda.synchronize()
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "device": str(dev),
            "span": [shard.start, shard.stop], "output_span": [y_oracle.start, y_oracle.stop],
            "tcn_ms": tcn_ms, "dcunet_ms": dcunet_ms, "oracle_ms": oracle_ms,
            "detect_ms": detect_ms, "labels": labels.tolist(),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "envelope_launches": envelope.launches, "phaser_launches": phaser.launches,
            "outputs": outs if dist.get_rank() == 0 else None}


def sequence_part(seed: int, n: int) -> dict:
    """Sequence-parallel inference of the joined file (1 x 1 x 1048576) at
    full width: every plan's windows against the whole file on one card,
    then shard_time over ``n`` NCCL ranks through launch.spawn, the TCN, a
    DCUNet and the five-slot chain (every label on, and detection) against
    the whole file on one card: within SEQ_TOL x the output's RMS, the
    labels equal. Wall times beside the one-card run, the peaks, the halos."""
    from remfx_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    torch.manual_seed(seed)
    cls, slots = build_slots(dev)
    x = torch.from_numpy(joined_clips()).to(dev)[None]
    envelope.launches = phaser.launches = 0
    windows, wholes = plan_windows(slots, cls, x)
    ones = torch.ones(1, len(ALL_EFFECTS), device=dev)
    # regroup: like run_time_sharded, it runs no model for a stage that no
    # row selects (single runs every model; the values are the same)
    detect_chain = ChainInference(slots, SR, classifier=cls, dispatch="regroup")
    detect_chain.run(x)  # warm-up (the windows ran every removal model)
    torch.cuda.reset_peak_memory_stats()
    one = {"tcn_ms": timed_ms(lambda: slots["RandomPedalboardDistortion"].sample(x))[1],
           "dcunet_ms": timed_ms(lambda: slots["RandomPedalboardReverb"].sample(x))[1]}
    (want_oracle, _), one["oracle_ms"] = timed_ms(lambda: ChainInference(slots, SR).remove(x, ones))
    (want_detect, want_labels), one["detect_ms"] = timed_ms(lambda: detect_chain.run(x))
    one["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    want = {"tcn": wholes["RandomPedalboardDistortion"], "dcunet": wholes["RandomPedalboardReverb"],
            "oracle": want_oracle, "detect": want_detect}
    want = {k: v.cpu() for k, v in want.items()}
    parent_launches = {"envelope": envelope.launches, "phaser": phaser.launches}
    del cls, slots, detect_chain, wholes, want_oracle, want_detect
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(sequence_rank, n, seed, device_type="cuda", timeout=JOIN_S)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        check(r["backend"] == "nccl" and r["device"].startswith("cuda"),
              f"rank {r['rank']}: backend {r['backend']} on {r['device']}")
        check(r["labels"] == want_labels.tolist(),
              f"rank {r['rank']}: labels {r['labels']} equal one card's {want_labels.tolist()}")
    launches = {"envelope": parent_launches["envelope"] + sum(r["envelope_launches"] for r in ranks),
                "phaser": parent_launches["phaser"] + sum(r["phaser_launches"] for r in ranks)}
    check(launches == {"envelope": 0, "phaser": 0}, f"the sequence path renders nothing: {launches}")
    errs = {}
    for k, v in want.items():
        got = torch.from_numpy(ranks[0]["outputs"][k])
        check(got.shape == v.shape, f"{k}: {tuple(got.shape)} against {tuple(v.shape)}")
        errs[k] = (got - v).abs().max().item() / rms(v)
        check(errs[k] <= SEQ_TOL, f"{k}: {n} ranks against one card {errs[k]} x RMS <= {SEQ_TOL}")
    for r in ranks:
        del r["outputs"]
    keys = ("tcn_ms", "dcunet_ms", "oracle_ms", "detect_ms")
    return {"ranks": n, "samples": x.shape[-1], "windows": windows,
            "rel_rms_err": errs, "bit_equal": {k: e == 0.0 for k, e in errs.items()},
            "labels": want_labels.tolist(), "one_card": one, "per_rank": ranks,
            "slowest_rank_ms": {k: max(r[k] for r in ranks) for k in keys},
            "speedup": {k: one[k] / max(r[k] for r in ranks) for k in keys},
            "spawn_s": spawn_s, "envelope_launches": launches["envelope"],
            "phaser_launches": launches["phaser"]}


def parallel_phase(seed: int, clips: torch.Tensor) -> dict:
    """The multi-device slice on every card there is: data-parallel fit on
    an NCCL group, the TCN's remat, PipelineChain, sequence-parallel
    inference of one long file, and dp x tp where there are two cards or
    more."""
    n = torch.cuda.device_count()
    out = {"cards": n}

    def part(name, fn, *args):
        out[name] = fn(*args)
        print(json.dumps({"parallel_part": name, name: out[name]}), flush=True)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        part("ddp", ddp_part, seed, Path(tmp), n)
    part("tcn_remat", tcn_remat_part, seed, torch.device("cuda", 0))
    part("pipeline", pipeline_part, seed, clips)
    part("sequence", sequence_part, seed, n)
    out["tensor_parallel"] = None
    if n >= 2:
        part("tensor_parallel", tensor_parallel_part, seed, n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["kernels", "blstm_graph", "bf16", "parallel", "sequence"],
                    help="run the device and build phases and this phase (or this "
                         "part of the parallel phase) alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    # same algorithms on every call, so "all" and oracle can be compared
    # bit for bit (TF32 is switched off by the port's resolve_device)
    torch.backends.cudnn.deterministic = True
    ph = Phases()
    dev = torch.device(DEVICE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    ph.done("device", kind=torch.cuda.get_device_name(0),
            count=torch.cuda.device_count(), nvidia_smi=smi,
            torch=torch.__version__, cuda=torch.version.cuda)

    built = _build.build(_build.all_sources())
    ph.done("build", nvcc_seconds=built, arch="sm_90a")

    gen = torch.Generator().manual_seed(args.seed)
    clips = torch.from_numpy(demo_clips()).to(dev)
    load_kernel_modules(dev)  # every path's counts are set to 0 before it
    if args.only == "parallel":
        par = parallel_phase(args.seed, clips)
        print(json.dumps({"parallel": par}), flush=True)
    if args.only == "sequence":
        seq = sequence_part(args.seed, torch.cuda.device_count())
        print(json.dumps({"parallel_part": "sequence", "sequence": seq}), flush=True)
    if args.only == "kernels":
        ph.done("kernels", kernels=[kernels_phase(clips, gen), phaser_row(
            clips, torch.Generator().manual_seed(args.seed + 1), args.seed + 1),
            group_norm_row(args.seed), dcunet_epilogue_row(args.seed)])
    elif args.only == "blstm_graph":
        ph.done("blstm_graph", **blstm_graph_row(args.seed))
    elif args.only == "bf16":
        ph.done("bf16", **bf16_run(args.seed, clips))
    elif args.only:
        ph.done(args.only)
    if args.only:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    row = kernels_phase(clips, gen)
    prow = phaser_row(clips, torch.Generator().manual_seed(args.seed + 1), args.seed + 1)
    gnrow = group_norm_row(args.seed)
    eprow = dcunet_epilogue_row(args.seed)
    ph.done("kernels", kernels=[row, prow, gnrow, eprow])
    ph.done("blstm_graph", **blstm_graph_row(args.seed))
    torch.cuda.empty_cache()
    phaser.launches = 0  # no path before the channel's renders a phaser

    # ---- the main path: counts at 0 just before, read just after ----
    envelope.launches = 0
    gn_before = group_norm.launches
    epi_before = dcunet_epilogue.launches
    params = compressor.sample_params(gen, B, COMP_RANGES, device=dev)
    wet = compressor.render_batch(clips[:, None, :], params, SR)
    torch.cuda.synchronize()
    main_launches = envelope.launches  # the main path's only envelope call
    check(main_launches >= 1, "render launched the envelope kernel")
    check(wet.shape == (B, 1, T) and bool(torch.isfinite(wet).all()),
          "rendered batch finite, (8, 1, 262144)")
    ph.done("render", envelope_launches=main_launches,
            peak_in=clips.abs().max().item(), peak_out=wet.abs().max().item())

    synth = synth_phase(clips, args.seed)  # counts its own path's launches
    ph.done("synth", **synth)
    envelope.launches = 0  # the rest of the main path

    torch.manual_seed(args.seed)
    cls, slots = build_slots(dev)
    chain = ChainInference(slots, SR, classifier=cls)
    dcunet_forwards = []  # the rows of each forward of the main path's DCUNets
    hooks = [w.module.register_forward_pre_hook(
                 lambda m, args: dcunet_forwards.append(args[0].shape[0]))
             for w in slots.values() if isinstance(w.module, DCUNet)]
    check(len(hooks) == 3, "three Large-DCUNet-20 slots")
    ph.done("build_slots", slots={k: type(w.module).__name__
                                  for k, w in slots.items()},
            parameters={k: sum(p.numel() for p in w.parameters())
                        for k, w in slots.items()})
    labels = chain.detect(wet)
    torch.cuda.synchronize()
    check(labels.shape == (B, len(ALL_EFFECTS)), "labels (8, 5)")
    ph.done("detect", labels_per_effect=per_effect(labels))

    oracle = torch.ones_like(labels)
    mixed = bits_pattern(B, dev)
    y_det, _ = chain.remove(wet, labels)
    y_oracle, _ = chain.remove(wet, oracle)
    y_mixed, _ = chain.remove(wet, mixed)
    chain_all = ChainInference(slots, SR, classifier=cls,
                               use_all_effect_models=True)
    y_all, labels_all = chain_all.run(wet)
    torch.cuda.synchronize()
    for name, y in (("detected", y_det), ("oracle", y_oracle),
                    ("mixed", y_mixed), ("all", y_all)):
        check(y.shape == (B, 1, T_OUT), f"{name} output (8, 1, {T_OUT})")
        check(bool(torch.isfinite(y).all()), f"{name} output finite")
    check(bool(torch.all(labels_all == 1)), "all: every label on")
    check(torch.equal(y_all, y_oracle), "all equals oracle bit for bit")
    ph.done("remove", all_equals_oracle=True, length=y_oracle.shape[-1],
            detected_per_effect=per_effect(labels),
            mixed_per_effect=per_effect(mixed),
            rms_in=rms(wet), rms_oracle=rms(y_oracle), rms_mixed=rms(y_mixed),
            rms_detected=rms(y_det))

    disp = dispatch_phase(slots, wet, clips, y_oracle)
    ph.done("dispatch", **disp)

    dry = clips[:, None, :]
    chain_oracle = ChainInference(slots, SR)
    metrics = chain_oracle.test_step((wet, dry, 0, oracle))
    torch.cuda.synchronize()
    metrics = {k: v.item() for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in metrics.values()), "test_step finite")
    ph.done("test_step", **metrics,
            peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    launches = {"envelope": main_launches + envelope.launches,
                "group_norm": group_norm.launches - gn_before,
                "dcunet_epilogue": dcunet_epilogue.launches - epi_before}
    check(launches["group_norm"] > 0, "the main path's HDemucs launched the GroupNorm kernel")
    for h in hooks:
        h.remove()
    epi_forwards = sum(1 for rows in dcunet_forwards if rows)
    check(epi_forwards > 0 and launches["dcunet_epilogue"] == 19 * epi_forwards,
          f"the main path's DCUNets took the packed path: {launches['dcunet_epilogue']} "
          f"epilogue launches in {epi_forwards} Large-DCUNet-20 forwards")
    # ---- end of the main path ----

    ph.done("cpu_vs_card", **cpu_vs_card(cls, slots, wet, dry))
    del cls, slots, chain, chain_all, chain_oracle
    torch.cuda.empty_cache()
    bf16 = bf16_run(args.seed, clips)
    ph.done("bf16", **bf16)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(args.seed, Path(tmp) / "train", row["device_kernels"])
        ph.done("train", **train)
        train_cls = train_cls_phase(args.seed, Path(tmp) / "train_cls",
                                    row["device_kernels"])
        ph.done("train_cls", **train_cls)

    trained, chain, chain_cfg = trained_phase(dev)
    ph.done("trained", **trained)
    with tempfile.TemporaryDirectory() as tmp:
        imported = torch_import_phase(chain, chain_cfg, Path(tmp))
    ph.done("torch_import", **imported)
    del chain
    torch.cuda.empty_cache()

    umx = umx_phase(args.seed, dev)
    ph.done("umx", **umx)
    torch.cuda.empty_cache()
    dptnet = dptnet_phase(args.seed, clips)
    ph.done("dptnet", **dptnet)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        default = train_default_phase(args.seed, Path(tmp) / "train_default")
    ph.done("train_default", **default)
    earlier_phaser = phaser.launches
    check(earlier_phaser == 0, f"no earlier path launched the phaser: {earlier_phaser}")

    channel = channel_phase(clips, args.seed)
    ph.done("channel", **channel)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phaser.launches = envelope.launches = 0
        generated = generate_dataset_phase(Path(tmp))
        generated_launches = {"phaser": phaser.launches, "envelope": envelope.launches}
        ph.done("generate_dataset", **generated, launches=generated_launches)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        matrix = eval_matrix_phase(Path(tmp))
    ph.done("eval_matrix", **matrix)
    with tempfile.TemporaryDirectory() as tmp:
        phaser.launches = envelope.launches = 0
        cls_pt = train_cls_pt_phase(args.seed, Path(tmp) / "train_cls_pt", clips)
        cls_pt_launches = {"phaser": phaser.launches, "envelope": envelope.launches}
    ph.done("train_cls_pt", **cls_pt, launches=cls_pt_launches)
    torch.cuda.empty_cache()
    par = parallel_phase(args.seed, clips)  # the ranks count their own launches
    print(json.dumps({"parallel": par}), flush=True)
    ph.done("parallel")

    row["launches_by_path"] = {"render_detect_remove": launches["envelope"],
                               "synth": synth["envelope_launches"],
                               "train": train["fit_envelope_launches"],
                               "train_cls": train_cls["envelope_launches"],
                               "trained": trained["envelope_launches"],
                               "stream": trained["stream"]["envelope_launches"],
                               "umx": umx["envelope_launches"],
                               "dptnet": dptnet["envelope_launches"],
                               "train_default": default["fit_envelope_launches"],
                               "torch_import": imported["envelope_launches"],
                               "channel": channel["launches"]["envelope"],
                               "channel_defaults": channel["default_launches"]["envelope"],
                               "generate_dataset": generated_launches["envelope"],
                               "train_cls_pt": cls_pt_launches["envelope"],
                               "parallel": par["ddp"]["envelope_launches"],
                               "sequence": par["sequence"]["envelope_launches"],
                               "bf16": bf16["launches"]["envelope"]}
    row["launches_per_train_default_step"] = default["envelope_launches_per_step"]
    row["launches"] = sum(row["launches_by_path"].values())
    prow["launches_by_path"] = {"before_channel": earlier_phaser,
                                "channel": channel["launches"]["phaser"],
                                "channel_defaults": channel["default_launches"]["phaser"],
                                "generate_dataset": generated_launches["phaser"],
                                "train_cls_pt": cls_pt_launches["phaser"],
                                "parallel": par["ddp"]["phaser_launches"],
                                "sequence": par["sequence"]["phaser_launches"],
                                "bf16": bf16["launches"]["phaser"]}
    prow["launches"] = channel["launches"]["phaser"]  # the channel's path
    gnrow["launches_by_path"] = {"render_detect_remove": launches["group_norm"],
                                 "bf16": bf16["launches"]["group_norm"]}
    gnrow["launches_by_phase"] = {k: v for k, v in ph.group_norm.items() if v}
    check(ph.group_norm["train"] > 0, "HDemucs's training under autograd launched the "
          "GroupNorm kernel")
    eprow["launches_by_path"] = {"render_detect_remove": launches["dcunet_epilogue"],
                                 "dcunet_forwards": epi_forwards}
    eprow["launches_by_phase"] = {k: v for k, v in ph.dcunet_epilogue.items() if v}
    print(json.dumps({"kernels": [row, prow, gnrow, eprow]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
