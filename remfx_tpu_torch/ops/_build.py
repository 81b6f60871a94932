"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/remfx_tpu_torch/`` at the
repository root at first use, then loaded with ``ctypes``. No PyTorch
header is included: that keeps a build to seconds, where
``torch.utils.cpp_extension`` takes minutes. A library is rebuilt when
its source or the flags change (the file name carries their hash).

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "remfx_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. -> {name: build seconds}; 0.0 where the library
    was already built. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        so = _target(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so, time.perf_counter())
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, so)
        seconds[name] = time.perf_counter() - t0
        print(f"[remfx_tpu_torch] built {so.name} in {seconds[name]:.2f} s",
              file=sys.stderr, flush=True)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def all_sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
