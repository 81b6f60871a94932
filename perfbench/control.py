"""Readings that the limits of ``correct`` are set from; run on a CUDA device.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... --controls 3
        [--leaves 3] [--noughts 1e-3,1e-8]

For each seed, the program's reading: the cell's set-up and its sampled
batches (the chain) or checked steps (training), compared with the fp32
reference as a measured run compares them. For the first ``--controls``
seeds also the control's: the reference in the program's place in the
precision below the configuration's (fp8 for the bf16 chain, TF32 for
fp32 training), and for training the half-batch fault planted in the
program (each step takes half its rows, the mean over the rest). For the
first ``--leaves`` seeds of training also, leaf by leaf, what the change
comparison's rule on the reference's gradient rests on: the leaf's first
gradient norm over the median leaf's, how far the fp32 reference's
gradient lies from an fp64 one (the norm of the difference over the fp64
norm: about 1 where the fp32 gradient is rounding alone), and the
program's gap of the change. With ``--noughts`` also each reading's
change gap under each of those rules on the reference's gradient. One
JSON line a seed on standard output.
The benchmark's measured runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def chain_rows(spec, config, seeds, controls, device="cuda"):
    import torch

    from perfbench.drivers import chain
    from perfbench.reference import fp32_exact
    from perfbench.reference.lowp import fp8_

    for k, seed in enumerate(seeds):
        cell = chain.Cell(config, spec, seed, device)
        cell.setup()
        cell.choose_samples(spec["sampled_batches"])
        for i in range(spec["sampled_batches"]):
            cell.iteration(i)
        cell.release()
        batches = sorted(cell.kept)
        with fp32_exact():
            want = cell.reference(batches)
            row = {"seed": seed, "program": cell.compare(cell.got(), want)}
            if k < controls:
                row["fp8"] = cell.compare(cell.reference(batches, control=fp8_), want)
        del cell, want
        torch.cuda.empty_cache()
        yield row


def first_gradients(cell, dtype):
    """{leaf: the reference's first-step gradient} in ``dtype``, over the
    same blocks of rows as the reference's steps (unclipped: the clip
    scales every leaf alike)."""
    import torch

    from perfbench.reference.train import removal_loss

    model = cell._reference_model().to(dtype).train()
    names, params = zip(*model.named_parameters())
    x, y = (t.to(cell.device, dtype) for t in (cell.pool[0][0], cell.pool[1][0]))
    rows, grads = cell.spec["reference_block_rows"], None
    for i in range(0, x.shape[0], rows):
        loss = removal_loss(model(x[i:i + rows]), y[i:i + rows]) * (min(rows, x.shape[0] - i)
                                                                     / x.shape[0])
        g = torch.autograd.grad(loss, params)
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    return dict(zip(names, grads))


def leaf_rows(cell, got, want):
    """Leaf by leaf: [name, gradient over the median leaf's, the fp32
    reference's gradient's relative gap from fp64, the program's gap of
    the change over max(the leaf's change, the median change)]."""
    import statistics

    import torch

    from perfbench.reference import fp32_exact

    with fp32_exact():
        g32 = first_gradients(cell, torch.float32)
        g64 = first_gradients(cell, torch.float64)
    grad_r, change, change_r = want[1], got[2], want[2]
    med, med_c = statistics.median(grad_r.values()), statistics.median(change_r.values())
    return [[n, grad_r[n] / med,
             ((g32[n].double() - g64[n]).norm() / g64[n].norm()).item(),
             abs(change[n] - change_r[n]) / max(change_r[n], med_c)] for n in grad_r]


def train_rows(spec, config, seeds, controls, device="cuda", leaves=0, noughts=()):
    import torch

    from perfbench.drivers import train_step
    from perfbench.reference import fp32_exact, precision
    from remfx_tpu_torch.train.tasks import RemovalTask

    def checked(seed):
        """Set-up, then the window's steps up to the last checked one."""
        cell = train_step.Cell(config, spec, seed, device)
        cell.setup()
        cell.choose_samples(None)
        for i in range(cell.checked - cell.warmup):
            cell.iteration(i)
        cell.release()
        return cell

    for k, seed in enumerate(seeds):
        cell = checked(seed)
        got = cell.got()
        with fp32_exact():
            want = cell.reference()
        row = {"seed": seed, "program": cell.compare(got, want)}
        readings = {"program": got}
        if k < controls:
            with precision(tf32=True):
                readings["tf32"] = cell.reference()
            row["tf32"] = cell.compare(readings["tf32"], want)
            step = RemovalTask.train_step

            def half(self, state, batch, rows=None):
                x, y = batch
                n = x.shape[0] // 2
                return step(self, state, (x[:n], y[:n]), rows)

            RemovalTask.train_step = half
            try:
                bad = checked(seed)
            finally:
                RemovalTask.train_step = step
            readings["half_batch"] = bad.got()
            row["half_batch"] = cell.compare(readings["half_batch"], want)
        if noughts:
            row["change_gap_by_nought"] = {
                str(t): {name: cell.compare(r, want, nought=t)["change_gap"]
                         for name, r in readings.items()} for t in noughts}
        if k < leaves:
            row["leaves"] = leaf_rows(cell, got, want)
        del cell
        torch.cuda.empty_cache()
        yield row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--leaves", type=int, default=0)
    parser.add_argument("--noughts", default="", help="comma-separated")
    args = parser.parse_args()

    from perfbench import harness

    bench = harness.load_json("BENCHMARK.json")
    spec, config = harness.cell_inputs(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if spec["driver"] == "chain":
        rows = chain_rows(spec, config, seeds, args.controls)
    else:
        noughts = [float(t) for t in args.noughts.split(",") if t]
        rows = train_rows(spec, config, seeds, args.controls, leaves=args.leaves,
                          noughts=noughts)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
