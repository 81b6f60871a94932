#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (remfx_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at full width, with seeded weights:
compressor render of 8 demo clips of 262144 samples at 48 kHz through the
hand-written envelope kernel -> Cnn14 detect (n_fft 2048, hop 512, 128
mels) -> HDemucs removal (channels 48, nfft 4096, depth 6, residual
wrapper) in the compressor slot of the chain.

Phases, each printing one JSON line with its elapsed seconds as it ends:
device, build (nvcc for sm_90a of every csrc/*.cu), kernels (each kernel
against its plain PyTorch version at the main path's shape, timed),
render, detect, remove (detected labels, oracle compressor labels, and
use_all_effect_models, which must equal oracle bit for bit), and
cpu_vs_card (clip 0 through detect and remove on the CPU with the same
weights). Then the kernel summary line, and the result line last.

Usage: python3 chip_smoke.py [--seed N]
Needs one CUDA device: with none it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.fx import compressor
from remfx_tpu_torch.models import make_cnn14, make_demucs
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.ops import _build
from remfx_tpu_torch.ops.envelope import envelope, envelope_plain

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
SLOT = "RandomPedalboardCompressor"
ENV_TOL = 2e-4  # x row peak: fp32 rounding through the 1/(1-cte) pole
CPU_TOL = 1e-3  # card vs CPU, TF32 off on both
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12
DEVICE = "cuda"


class Phases:
    def __init__(self):
        self.start = time.perf_counter()
        self.last = self.start

    def done(self, phase: str, /, **fields):
        now = time.perf_counter()
        line = {"phase": phase, "seconds": round(now - self.last, 3),
                "total_seconds": round(now - self.start, 3), **fields}
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


def time_kernel(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median ms of ``reps`` launches, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels_phase(clips: torch.Tensor, gen: torch.Generator) -> dict:
    """The envelope kernel against envelope_plain at the main path's shape."""
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
    kernel_ms = time_kernel(lambda: envelope(xa, at, rl))
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
        "max_abs_err": diff.max().item(),
        "max_rel_err": max_rel,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "ns_per_step": kernel_ms * 1e6 / steps,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    row = kernels_phase(clips, gen)
    ph.done("kernels", **row)

    # ---- the main path: counts at 0 just before, read just after ----
    envelope.launches = 0
    params = compressor.sample_params(gen, B, COMP_RANGES, device=dev)
    wet = compressor.render_batch(clips[:, None, :], params, SR)
    torch.cuda.synchronize()
    check(envelope.launches >= 1, "render launched the envelope kernel")
    check(wet.shape == (B, 1, T) and bool(torch.isfinite(wet).all()),
          "rendered batch finite, (8, 1, 262144)")
    ph.done("render", envelope_launches=envelope.launches,
            peak_in=clips.abs().max().item(), peak_out=wet.abs().max().item())

    torch.manual_seed(args.seed)
    cls = make_cnn14(num_classes=len(ALL_EFFECTS), sample_rate=SR, device=dev,
                     **CNN14)
    # residual wrapper with torch-default (nonzero) init: identity_init's
    # zeroed final convs would make the stage a no-op
    demucs = ModelWrapper(make_demucs(sample_rate=SR, device=dev, **DEMUCS).module,
                          name="demucs", residual=True)
    chain = ChainInference({SLOT: demucs}, SR, classifier=cls)
    labels = chain.detect(wet)
    torch.cuda.synchronize()
    check(labels.shape == (B, len(ALL_EFFECTS)), "labels (8, 5)")
    ph.done("detect", labels_per_effect=dict(zip(
        ALL_EFFECTS, labels.sum(dim=0).int().tolist())))

    comp = ALL_EFFECTS.index("compressor")
    oracle = torch.zeros_like(labels)
    oracle[:, comp] = 1.0
    y_det, _ = chain.remove(wet, labels)
    y_oracle, _ = chain.remove(wet, oracle)
    chain_all = ChainInference({SLOT: demucs}, SR, classifier=cls,
                               use_all_effect_models=True)
    y_all, labels_all = chain_all.run(wet)
    torch.cuda.synchronize()
    for name, y in (("detected", y_det), ("oracle", y_oracle), ("all", y_all)):
        check(y.shape == (B, 1, T), f"{name} output (8, 1, 262144)")
        check(bool(torch.isfinite(y).all()), f"{name} output finite")
    check(bool(torch.all(labels_all == 1)), "all: every label on")
    check(torch.equal(y_all, y_oracle), "all equals oracle bit for bit")
    launches = {"envelope": envelope.launches}
    ph.done("remove", all_equals_oracle=True,
            rms_in=wet.pow(2).mean().sqrt().item(),
            rms_oracle=y_oracle.pow(2).mean().sqrt().item(),
            max_abs_change_oracle=(y_oracle - wet).abs().max().item())
    # ---- end of the main path ----

    cpu = torch.device("cpu")
    cls_cpu = copy.deepcopy(cls).to(cpu)
    demucs_cpu = copy.deepcopy(demucs).to(cpu)
    chain_cpu = ChainInference({SLOT: demucs_cpu}, SR, classifier=cls_cpu)
    with torch.no_grad():
        probs_card = cls(wet[:1]).cpu()
        probs_cpu = cls_cpu(wet[:1].cpu())
    y_cpu, _ = chain_cpu.remove(wet[:1].cpu(), oracle[:1].cpu())
    # an fp64 run of the same removal says which side carries the error
    y_64 = copy.deepcopy(demucs_cpu).double().sample(wet[:1].cpu().double())
    probs_err = (probs_card - probs_cpu).abs().max().item()
    card = y_oracle[:1].cpu()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

    remove_rel = rel(y_cpu, card)
    check(probs_err <= CPU_TOL, f"probs card vs CPU {probs_err} <= {CPU_TOL}")
    check(remove_rel <= CPU_TOL, f"removal card vs CPU {remove_rel} <= {CPU_TOL}")
    ph.done("cpu_vs_card", probs_max_abs_err=probs_err,
            remove_max_rel_err=remove_rel, card_vs_fp64=rel(card, y_64),
            cpu_vs_fp64=rel(y_cpu, y_64))

    row["launches"] = launches["envelope"]
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
