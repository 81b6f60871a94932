"""Start one process per device and run a function in each.

``spawn(fn, n, *args, device_type=...)`` starts ``n`` ranks with the
``spawn`` start method, joins them into one process group (NCCL on the
card, each rank on ``cuda:{local_rank}``; gloo on the CPU, one thread a
rank; cuDNN's ``deterministic`` and ``benchmark`` as in the caller),
calls ``fn(*args)`` in each and returns the results by rank. The
rendezvous is a ``file://`` store in a temporary directory of its own, so
that launches running side by side (parallel test workers) never meet.

A rank that raises fails the call with its traceback, naming the rank;
the other ranks, which may be waiting for it in a collective, are ended.
With ``timeout``, a launch whose ranks have not all returned by then is
ended the same way, naming the ranks that had not. Nothing falls back: a
group that does not form is an error.

A process started by ``torchrun`` is a rank already: ``from_torchrun``
tells, and ``init_from_env`` joins its group from ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.

``fn`` must be importable by name (a module-level function of this
package), and its arguments and result picklable; a result is best numpy
arrays or plain Python values, since a rank's tensors do not outlive it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from remfx_tpu_torch.utils.logging import mute_other_ranks

# a collective that waits longer than this raises in its rank
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def available(device_type: str) -> int:
    """Devices one rank each can take: the cards, or the CPU's cores."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def check_devices(devices: int, device_type: str):
    have = available(device_type)
    if devices > have:
        raise ValueError(f"trainer.devices={devices} but only {have} "
                         f"{device_type} devices present")


def from_torchrun() -> bool:
    """Whether this process was started by ``torchrun`` (or anything that
    sets its environment) and has not joined its group yet."""
    return ("RANK" in os.environ and "WORLD_SIZE" in os.environ
            and not dist.is_initialized())


def _bind(device_type: str, local_rank: int):
    """This rank's device; a rank other than 0 logs warnings only."""
    mute_other_ranks()
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass accelerator=cpu to run on the CPU")
        torch.cuda.set_device(local_rank)
        return torch.device("cuda", local_rank)
    torch.set_num_threads(1)
    return None


def init_from_env(device_type: str):
    """Join the group that ``torchrun``'s environment describes."""
    device_id = _bind(device_type, int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device_type), init_method="env://",
                            timeout=COLLECTIVE_TIMEOUT, device_id=device_id)


def _rank_main(rank, world, store, device_type, cudnn, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    try:
        device_id = _bind(device_type, rank)
        dist.init_process_group(backend_for(device_type), init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT, device_id=device_id)
        out = fn(*args)
        dist.barrier()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, device_type: str = "cuda",
          timeout: float | None = None) -> list:
    """``fn(*args)`` on ``nprocs`` ranks of one new process group; -> the
    results, by rank."""
    check_devices(nprocs, device_type)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = None if timeout is None else time.monotonic() + timeout
    # the ranks choose cuDNN's algorithms as this process does
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory(prefix="remfx_launch_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, store, device_type, cudnn, fn, args,
                                   results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got: dict = {}
        try:
            while len(got) < nprocs:
                try:
                    rank, err, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {nprocs} exited with "
                                           f"code {procs[dead[0]].exitcode} and no result")
                    if deadline is not None and time.monotonic() > deadline:
                        late = [r for r in range(nprocs) if r not in got]
                        raise TimeoutError(f"ranks {late} of {nprocs} did not finish "
                                           f"within {timeout} s")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{err}")
                got[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(nprocs)]
