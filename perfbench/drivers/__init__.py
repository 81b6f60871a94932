"""Window drivers: one module per kind of work a cell's window drives.

A driver module defines ``Cell(config, spec, seed, device)`` with
``setup()``; ``choose_samples(first)``, which of the window's first
``first`` iterations to keep for the comparison (None: the workload's own
rule); ``iteration(i)``, which returns the work it finished in audio
seconds; ``release()``; ``verify()``, a list of ``(name, value, limit)``;
and ``flops_per_iteration()``. A workload file names its driver.
"""

import torch


def factory_keys(entry: dict) -> dict:
    """A configuration's model entry as keys of the program's factory: all
    but the benchmark's own ``kind`` and ``init``."""
    return {k: v for k, v in entry.items() if k not in ("kind", "init")}


def sync(device):
    """Wait for the card, where the run has one."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
