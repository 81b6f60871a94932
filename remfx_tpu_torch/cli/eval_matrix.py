"""Table-4-style evaluation matrix: the composed detect / oracle / all
chains over frozen rendered test sets, one table of SI-SDR and MR-STFT
against the ``Input_*`` baselines.

Counterpart of ``scripts/eval_matrix.py``, with its flags; the
reference's standardised evaluation is ``eval.sh {remfx_oracle|
remfx_detect|remfx_all} N-N`` over rendered test sets (reference
scripts/eval.sh:36-47; chain semantics remfx/models.py:22-149):

    python -m remfx_tpu_torch.cli.eval_matrix \\
        --n 0,1,2,5 --variants oracle,detect,all --test-chunks 256 \\
        --ckpt RandomPedalboardDistortion=ckpts/tcn_distortion_aug \\
        ... --classifier ckpts/classifier_cnn14_r5

Each (variant, N) cell runs in its own subprocess, so the sweep is
resumable: cells already in ``--out/eval_matrix.json`` are skipped. The
test set of each N is rendered once into ``--root`` (the reference's
directory layout) from the rich synthetic source and reused afterwards
(``REMFX_RENDER_REUSE=1``). Results land in ``--out`` as
``eval_matrix.json`` and ``eval_matrix.md``.

Beside the JAX script's flags, ``--accelerator cpu`` runs every cell on
the host; by default they run on the card. ``--real-files`` defaults to
none: the JAX script's default names a file outside the repository, and
the rich source drops files that do not exist, so both defaults render
the same sets.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

VARIANT_EXP = {
    "oracle": "remfx_oracle",
    "detect": "remfx_detect",
    "all": "remfx_all",
}
ROOT = Path(__file__).resolve().parents[2]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", default="0,1,2,5",
                    help="comma-separated removed-effect counts")
    ap.add_argument("--variants", default="oracle,detect,all")
    ap.add_argument("--test-chunks", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--root", default="data/eval_matrix",
                    help="render root for the frozen eval sets")
    ap.add_argument("--out", default="logs/eval_matrix")
    ap.add_argument("--ckpt", action="append", default=[],
                    metavar="EFFECT_CLASS=PATH",
                    help="vendored ckpt dir per effect class (repeat)")
    ap.add_argument("--classifier", default="ckpts/classifier_cnn14")
    ap.add_argument("--real-files", default="",
                    help="comma-separated real wavs for the rich source")
    ap.add_argument("--accelerator", default=None,
                    help="'cpu' runs the cells on the host; default the card")
    ap.add_argument("--cell", default=None,
                    help="internal: run ONE variant:n cell and print its "
                         "row as the last stdout line")
    return ap.parse_args(argv)


def build_cfg(args, exp_name, n):
    from remfx_tpu_torch.config.core import parse_cli

    argv = [
        f"+exp={exp_name}",
        "render_files=False",
        f"render_root={args.root}",
        f"num_removed_effects=[{n},{n}]",
        f"datamodule.test_batch_size={args.batch}",
        f"datamodule.test_chunks={args.test_chunks}",
        "datamodule.synthetic=true",
        "datamodule.synthetic_rich=true",
        "datamodule.synthetic_real_files=[" + args.real_files + "]",
        f"classifier_ckpt={args.classifier}",
    ]
    if args.accelerator:
        argv.append(f"accelerator={args.accelerator}")
    cfg = parse_cli(argv)
    for spec in args.ckpt:
        effect_class, path = spec.split("=", 1)
        if effect_class not in cfg["ckpts"]:
            raise SystemExit(f"unknown effect class {effect_class!r}")
        cfg["ckpts"][effect_class]["ckpt_path"] = path
    return cfg


def ensure_rendered(args, cfg):
    """Render the frozen test set for this N if absent (once per N)."""
    from remfx_tpu_torch.train.loop import build_datamodule

    rcfg = copy.deepcopy(cfg)
    rcfg["render_files"] = True
    rcfg["datamodule"]["train_chunks"] = 0
    rcfg["datamodule"]["val_chunks"] = 0
    os.environ.setdefault("REMFX_RENDER_REUSE", "1")
    build_datamodule(rcfg)  # side effect: renders missing splits


def run_cell(args) -> dict:
    """One (variant, n) evaluation in this process; prints its row as the
    last stdout line and returns it."""
    from remfx_tpu_torch.chain.build import build_chain
    from remfx_tpu_torch.train.loop import build_datamodule, device_of

    variant, n = args.cell.split(":")
    n = int(n)
    cfg = build_cfg(args, VARIANT_EXP[variant], n)
    ensure_rendered(args, cfg)
    device = device_of(cfg)
    datamodule = build_datamodule(cfg, device)
    t0 = time.perf_counter()
    chain = None
    metrics = []
    for batch in datamodule.test_dataloader():
        batch = tuple(torch.as_tensor(t).to(device) for t in batch)
        if chain is None:
            chain = build_chain(cfg, batch[0], device=device)
        metrics.append({k: float(v) for k, v in chain.test_step(batch).items()})
    means = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
    means.update(variant=variant, n=n, examples=args.test_chunks,
                 wall_s=time.perf_counter() - t0)
    print(json.dumps(means), flush=True)
    return means


def write_table(rows, out: Path):
    lines = [
        "| variant | N | SI-SDR | Input_SISDR | dSISDR | MR-STFT "
        "| Input_STFT | dSTFT |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        si, isi = r.get("test_SISDR", 0), r.get("Input_SISDR", 0)
        st, ist = r.get("test_STFT", 0), r.get("Input_STFT", 0)
        lines.append(
            f"| {r['variant']} | {r['n']} | {si:.3f} | {isi:.3f} "
            f"| {si - isi:+.3f} | {st:.3f} | {ist:.3f} | {ist - st:+.3f} |"
        )
    out.write_text("\n".join(lines) + "\n")
    return "\n".join(lines)


def cell_row(cmd: list) -> dict:
    """Run one cell's subprocess -> its row (the last stdout line)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    tail = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not tail:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise SystemExit(f"cell {cmd[-1]} failed (rc={proc.returncode})")
    return json.loads(tail[-1])


def main(argv=None) -> list:
    args = parse_args(argv)
    if args.cell:
        return [run_cell(args)]

    ns = [int(s) for s in args.n.split(",") if s != ""]
    variants = [s for s in args.variants.split(",") if s != ""]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows_path = out / "eval_matrix.json"
    rows = json.loads(rows_path.read_text()) if rows_path.exists() else []
    done = {(r["variant"], r["n"]) for r in rows}

    base_cmd = [sys.executable, "-m", "remfx_tpu_torch.cli.eval_matrix"]
    for a in ("n", "variants", "root", "out", "classifier"):
        base_cmd += [f"--{a}", str(getattr(args, a))]
    base_cmd += ["--test-chunks", str(args.test_chunks),
                 "--batch", str(args.batch),
                 "--real-files", args.real_files]
    if args.accelerator:
        base_cmd += ["--accelerator", args.accelerator]
    for spec in args.ckpt:
        base_cmd += ["--ckpt", spec]

    for n in ns:
        for variant in variants:
            if (variant, n) in done:
                print(f"skip {variant}:{n} (already in {rows_path})", flush=True)
                continue
            row = cell_row(base_cmd + ["--cell", f"{variant}:{n}"])
            rows.append(row)
            print(json.dumps(row), flush=True)
            rows_path.write_text(json.dumps(rows, indent=1))

    print(write_table(rows, out / "eval_matrix.md"))
    return rows


if __name__ == "__main__":
    main()
