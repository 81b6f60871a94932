"""Device mesh and the data-parallel / tensor-parallel helpers.

Counterpart of ``remfx_tpu/parallel/mesh.py``. The JAX package is one
process over a ``("dp", "tp")`` mesh and lets GSPMD insert the
collectives; here each device is one process (``parallel/launch.py``),
NCCL on the card and gloo on the CPU, and the same values come out of
explicit collectives:

  * ``make_mesh``: a ``DeviceMesh`` over every rank, dims ``("dp", "tp")``;
  * ``shard_batch`` / ``batch_rows``: this rank's rows of the global batch
    (the split is over ``dp`` only, so the ``tp`` ranks of one ``dp``
    coordinate see the same rows); ``replicate``: rank 0's model on every
    rank;
  * ``shard_params_channels`` / ``shard_tcn_params``: FSDP2 over the 2-D
    mesh, replicated over ``dp`` and sharded over ``tp`` (parameters,
    gradients and AdamW state); as the JAX placement, a layout and never a
    change of the values;
  * ``split_batch``: the context in which a split batch's train-mode
    statistics (``models/batchnorm.py``, the DCUNet's complex norm) and
    per-row draws (Cnn14's SpecAugment) are those of the global batch.

``shard_time`` (one long file split in time) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

_SPLIT: contextvars.ContextVar = contextvars.ContextVar("remfx_split_batch", default=None)


def make_mesh(dp: int | None = None, tp: int = 1, devices=None):
    """A ``DeviceMesh`` of shape ``(dp, tp)`` named ``("dp", "tp")`` over
    ``devices``, one per rank of the process group (default: every rank,
    on this rank's device type). ``dp * tp`` must be the device count."""
    if devices is None:
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        devices = [torch.device(kind)] * dist.get_world_size()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    if n != dist.get_world_size():
        raise ValueError(f"{n} devices but {dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(devices[0].type, (dp, tp), mesh_dim_names=("dp", "tp"))


def mesh_shape(mesh) -> dict:
    """``{"dp": dp, "tp": tp}``, as the JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class Rows:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``
    rows; ``group`` is the ``dp`` group they are split over, or None."""

    start: int
    stop: int
    total: int
    group: object = None

    @property
    def split(self) -> bool:
        return self.group is not None and self.stop - self.start < self.total

    def take(self, t):
        return t[self.start:self.stop]


def batch_rows(n: int, mesh=None, strict: bool = True) -> Rows:
    """The rows this rank keeps of a global batch of ``n``, by the JAX
    loop's ``_shard`` rule: split over ``dp``; a ragged batch with ``n >=
    dp`` trimmed to the largest ``dp`` multiple (drop-last, with a warning),
    unless ``strict`` is off (evaluation), which replicates it instead; a
    batch of fewer than ``dp`` rows replicated."""
    if mesh is None:
        return Rows(0, n, n)
    dp = mesh.size(0)
    if n % dp and not (strict and n >= dp):
        return Rows(0, n, n)  # every rank holds the whole batch
    keep = (n // dp) * dp
    if keep != n:
        warnings.warn(f"trimming ragged batch {n} -> {keep} (dp={dp}, drop-last)",
                      stacklevel=2)
    b = keep // dp
    r = mesh.get_local_rank("dp")
    return Rows(r * b, (r + 1) * b, keep, mesh.get_group("dp"))


def shard_batch(batch, mesh):
    """This rank's rows of each tensor of ``batch`` (the leading axis split
    over ``dp``, the same rows on every ``tp`` rank)."""
    n = batch[0].shape[0]
    if n % mesh.size(0):
        raise ValueError(f"batch of {n} does not split over dp={mesh.size(0)}")
    rows = batch_rows(n, mesh)
    return tuple(rows.take(t) for t in batch)


@torch.no_grad()
def replicate(module: nn.Module, mesh) -> nn.Module:
    """Rank 0's parameters and buffers of ``module`` on every rank of
    ``mesh``, in place (a batch needs no such step: every rank draws the
    same global batch)."""
    src = int(mesh.mesh.flatten()[0])
    for t in module.state_dict().values():
        dist.broadcast(t, src=src)
    return module


def all_reduce_mean_(tensors, group=None):
    """Each tensor replaced by its mean over ``group``, in one bucketed
    ``all_reduce`` per dtype (the gradient average of data parallelism)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    n = dist.get_world_size(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= n
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return tensors


def _fsdp():
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    return fully_shard, MixedPrecisionPolicy


def _mp_policy(param_dtype):
    """bf16 compute copies of fp32 masters, gradients reduced in fp32: the
    arithmetic of the tasks' bf16-mixed cast (``train/tasks.py``)."""
    _, policy = _fsdp()
    if param_dtype is None:
        return policy()
    return policy(param_dtype=param_dtype, reduce_dtype=torch.float32,
                  cast_forward_inputs=False)


def shard_params_channels(module: nn.Module, mesh, param_dtype=None):
    """FSDP2 over ``mesh``: replicated over ``dp``, every parameter (and its
    gradient and AdamW state) sharded over ``tp``. ``param_dtype``
    (bfloat16) is the dtype the forward computes in. In place; returns
    ``module``, whose parameters are now ``DTensor``s."""
    fully_shard, _ = _fsdp()
    fully_shard(module, mesh=mesh, mp_policy=_mp_policy(param_dtype))
    return module


def shard_tcn_params(module: nn.Module, mesh, param_dtype=None):
    """``shard_params_channels`` for the TCN, one FSDP unit per block, so a
    block's parameters are gathered only while it runs."""
    fully_shard, _ = _fsdp()
    for block in module.process_blocks:
        fully_shard(block, mesh=mesh, mp_policy=_mp_policy(param_dtype))
    return shard_params_channels(module, mesh, param_dtype)


@contextlib.contextmanager
def split_batch(rows: Rows):
    """Within: train-mode batch statistics and per-row draws are those of
    the global batch that ``rows`` is a part of (nothing changes when the
    rows are the whole batch)."""
    token = _SPLIT.set(rows if rows.split else None)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def current_split() -> Rows | None:
    """The ``Rows`` of the enclosing ``split_batch`` when they are a part
    of the batch, else None."""
    return _SPLIT.get()


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a group; its gradient is the sum of the
    ranks' gradients (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_means(tensors, dims, rows: Rows):
    """The means of ``tensors`` over ``dims`` across the global batch that
    ``rows`` is a part of: the per-rank sums in one differentiable
    ``all_reduce`` over ``rows.group``, over the global count (every rank
    holds equal rows of a split batch)."""
    count = dist.get_world_size(rows.group)
    for d in dims:
        count *= tensors[0].shape[d]
    sums = _AllReduceSum.apply(torch.stack([t.sum(dims) for t in tensors]), rows.group)
    return list((sums / count).unbind(0))
