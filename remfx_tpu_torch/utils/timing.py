"""Wall timing of a call that ends on the device (``remfx_tpu/utils/timing.py``).

PyTorch returns before a CUDA call finishes, so each timed call is
followed by ``torch.cuda.synchronize()`` on the tensors' device.
"""

from __future__ import annotations

import time

import torch


def _sync(out):
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for v in leaves:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def timeit(fn, *args, iters: int = 5, warmup: int = 2, repeats: int = 3,
           **kwargs):
    """-> (median seconds per call over ``repeats`` blocks of ``iters``
    calls, the last call's output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync(out)
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
            _sync(out)
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return times[len(times) // 2], out
