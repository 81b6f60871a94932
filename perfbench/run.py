"""The benchmark of ``remfx_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's program and inputs from
the seed and warms up (set-up); prints the settings it runs under (the
cuDNN and TF32 flags as set-up left them, the versions, the card, its
power limit and clocks); then measures for ``--seconds`` (``--trace 0``:
the cell's end-to-end metrics), or times and then traces the workload's
stated numbers of iterations (``--trace 1``: its per-layer metrics). It
compares what the timed path produced with the plain reference, prints
the numbers compared beside their limits as the last lines of standard
error, and prints one JSON line last on standard output. Without a CUDA
device, or with fewer than the cell asks for, it exits with code 3 and
prints no result; so it does where a module of JAX or of the JAX package
was loaded. Where set-up leaves TF32 other than the configuration states,
it exits with another code than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's kernel caches, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "remfx_tpu"}


def forbidden_modules() -> set:
    return FORBIDDEN & {name.split(".")[0] for name in sys.modules}


def settings(torch) -> list[str]:
    lines = [f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"cudnn {torch.backends.cudnn.version()}",
             f"cudnn.benchmark {torch.backends.cudnn.benchmark} "
             f"cudnn.deterministic {torch.backends.cudnn.deterministic} "
             f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} "
             f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}",
             f"card {torch.cuda.get_device_name(0)}"]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        lines.append(f"nvidia-smi {smi.stdout.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        lines.append(f"nvidia-smi unavailable: {e}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    bench = harness.load_json("BENCHMARK.json")
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    def print_settings():
        for line in settings(torch):
            print(line, file=sys.stderr)

    spec, config = harness.cell_inputs(bench, args.workload)
    result = harness.run_cell(bench, args.workload, spec, config, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0, torch.cuda.get_device_name(0),
                              after_setup=print_settings)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {sorted(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
