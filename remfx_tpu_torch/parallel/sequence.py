"""Sequence-parallel inference of one long file: its time axis split over
the ranks of a mesh axis (``parallel.shard_time``).

Counterpart of what ``remfx_tpu/parallel/mesh.py:shard_time`` gives the
JAX package: there GSPMD inserts the halo exchanges around every
convolution and STFT framing, so that a jitted ``sample`` of a
time-sharded file equals the one-device ``sample`` of the whole file. The
port has no GSPMD: each backbone has a time plan, looked up by its type in
an explicit table (``time_plan``), and the collectives are explicit.

* ``HaloPlan`` (the TCN, the DCUNet): a rank runs the model on its span
  widened by the model's reach (``time_reach()`` of the module), the
  window's ends on the model's grid (``time_alignment()``), and keeps the
  outputs it owns. The widening comes from the neighbours in one
  ``batch_isend_irecv`` (``halo_exchange``).

  - TCN: valid convolutions, output ``j`` reads input ``[j, j + rf - 1]``,
    so the halo is ``rf - 1`` samples on the right; the output is ``T - rf
    + 1`` samples long on the same grid.
  - DCUNet: asteroid's framing conv at hop ``K / 2`` and a U-Net whose time
    strides multiply to ``time_prod``. A window starts and ends on
    multiples of ``(K / 2) * time_prod``, so its frames and stride phases
    fall on the whole file's, and reaches the masker's span of frames past
    the span; the zeros the window's own edges add (its ``pad_t`` frames,
    the U-Net's "same" padding) change only outputs within that reach of
    the edges, which are dropped. At the file's ends the window is the
    file's, so the last rank reproduces the short-file pad and the zero
    tail past the last full frame.

* ``GatherPlan``: the whole file on every rank (``gather_time``), the
  model on it, the rank's span kept. Bit for bit the one-device result,
  and no faster: no halo bounds these models (the reasons are in the
  table).

``span_sample`` is a plan's arithmetic with no collective: the model on a
window, the owned outputs kept. ``sample_time_sharded`` is the exchange
followed by ``span_sample``, and ``sample_windows`` runs every rank's
window in one process, so that one device can hold each plan against the
whole file.

Outputs lie on the global output grid: rank r owns output samples
``[start, stop) ∩ [0, T_out)``; a rank whose span lies past ``T_out``
holds an empty span and still joins every collective. ``run_time_sharded``
is ``ChainInference.run`` over a time-sharded file: every decision to skip
a stage comes from the labels, which every rank holds, so all ranks run
the same collectives in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.models.cnn14 import Cnn14
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.dptnet import DPTNet
from remfx_tpu_torch.models.embedding_classifiers import EmbeddingClassifier
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.umx import UMXSeparator
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.parallel.mesh import TimeShard, gather_time
from remfx_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class HaloPlan:
    """Outputs ``[o0, o1)`` read input ``[o0 - left, o1 + right)``; a
    window starts and ends on multiples of ``align`` (or at the file's
    ends)."""

    left: int
    right: int
    align: int = 1

    def window(self, length: int, keep: tuple[int, int]) -> tuple[int, int]:
        """The input window ``[a, b)`` of a signal of ``length`` samples
        that gives the outputs ``keep``."""
        o0, o1 = keep
        a = (o0 - self.left) // self.align * self.align
        b = -(-(o1 + self.right) // self.align) * self.align
        return max(a, 0), min(b, length)


@dataclass(frozen=True)
class GatherPlan:
    """The whole signal on every rank; ``why`` no halo bounds the model."""

    why: str

    def window(self, length: int, keep: tuple[int, int]) -> tuple[int, int]:
        return 0, length


def _halo(module) -> HaloPlan:
    return HaloPlan(*module.time_reach(), module.time_alignment())


def _gather(why: str):
    return lambda module: GatherPlan(why)


# every backbone's plan, by its type; a type not listed has none
PLANS = {
    TCN: _halo,
    DCUNet: _halo,
    HDemucs: _gather("normalises by the whole file's mean and standard deviation in "
                     "both branches, and its LocalState attention spans the whole "
                     "sequence"),
    UMXSeparator: _gather("its LSTM runs over the whole sequence"),
    DPTNet: _gather("GlobLN takes mean and variance over all time, and its "
                    "inter-chunk transformer is global"),
    Cnn14: _gather("it pools over all time at its head"),
    EmbeddingClassifier: _gather("its Cnn14 trunk pools over all time"),
}


def time_plan(model):
    """The time plan of ``model`` (a ``ModelWrapper`` or a classifier),
    from ``PLANS``; an unlisted module type raises ``TypeError``."""
    module = model.module if isinstance(model, ModelWrapper) else model
    make = PLANS.get(type(module))
    if make is None:
        raise TypeError(f"no time plan for {type(module).__name__}: the plans are "
                        f"{sorted(t.__name__ for t in PLANS)}")
    return make(module)


def _per_rank(amount, n: int) -> list:
    return [amount] * n if isinstance(amount, int) else list(amount)


def halo_exchange(shard: TimeShard, left, right) -> TimeShard:
    """This rank's span widened by ``left`` samples from the ranks before it
    and ``right`` from the ranks after it (ints, or one per rank), in one
    ``batch_isend_irecv``. Nothing comes from before the file's start or
    after its end, nor to a rank whose span is empty. A halo that reaches
    past the adjacent rank's span raises ``ValueError``. -> a ``TimeShard``
    of the window."""
    n, r = shard.ranks, shard.rank
    lefts, rights = _per_rank(left, n), _per_rank(right, n)
    spans = [shard.span(i) for i in range(n)]
    got = []  # (from the left, from the right) of each rank
    for i, (s, e) in enumerate(spans):
        lo, hi = (min(lefts[i], s), min(rights[i], shard.length - e)) if e > s else (0, 0)
        for amount, j in ((lo, i - 1), (hi, i + 1)):
            if amount and amount > spans[j][1] - spans[j][0]:
                raise ValueError(
                    f"a halo of {amount} samples for rank {i} reaches past rank {j}'s "
                    f"span [{spans[j][0]}, {spans[j][1]})")
        got.append((lo, hi))
    lo, hi = got[r]
    data = shard.data
    lead = data.shape[:-1]
    from_left, from_right = data.new_empty((*lead, lo)), data.new_empty((*lead, hi))

    def op(kind, tensor, i):
        return dist.P2POp(kind, tensor, dist.get_global_rank(shard.group, i), shard.group)

    ops = []
    if lo:
        ops.append(op(dist.irecv, from_left, r - 1))
    if hi:
        ops.append(op(dist.irecv, from_right, r + 1))
    if r > 0 and got[r - 1][1]:  # this span's start ends the window before
        ops.append(op(dist.isend, data[..., :got[r - 1][1]].contiguous(), r - 1))
    if r + 1 < n and got[r + 1][0]:  # its end starts the window after
        ops.append(op(dist.isend, data[..., data.shape[-1] - got[r + 1][0]:].contiguous(), r + 1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return TimeShard(torch.cat([from_left, data, from_right], dim=-1), shard.start - lo,
                     shard.stop + hi, shard.length, shard.step, r, n, shard.axis, shard.group)


def _keep(shard: TimeShard, length_out: int, i: int | None = None) -> tuple[int, int]:
    """Rank ``i``'s (this rank's) output span on the grid: its span
    ``∩ [0, length_out)``."""
    s, e = shard.span(shard.rank if i is None else i)
    return min(s, length_out), min(e, length_out)


def _exchange(plan, shard: TimeShard, length_out: int) -> TimeShard:
    """The window this rank's outputs need: the whole signal under a
    ``GatherPlan``, else its span widened through ``halo_exchange``."""
    if isinstance(plan, GatherPlan):
        whole = gather_time(shard)
        return TimeShard(whole, 0, shard.length, shard.length, shard.step, shard.rank,
                         shard.ranks, shard.axis, shard.group)
    lefts, rights = [], []
    for i in range(shard.ranks):
        keep = _keep(shard, length_out, i)
        s, e = shard.span(i)
        a, b = plan.window(shard.length, keep) if keep[1] > keep[0] else (s, e)
        lefts.append(s - a)
        rights.append(b - e)
    return halo_exchange(shard, lefts, rights)


def span_sample(wrapper, plan, window: TimeShard, keep: tuple[int, int]) -> torch.Tensor:
    """``wrapper.sample`` of the outputs ``keep = [o0, o1)`` of the global
    output grid, from ``window``, which must be the plan's window for them
    (``ValueError`` otherwise). No collective. An empty ``keep`` runs
    nothing and gives an empty span."""
    o0, o1 = keep
    data = window.data
    if o1 <= o0:
        return data.new_empty((*data.shape[:-1], 0))
    a, b = plan.window(window.length, keep)
    if (window.start, window.stop) != (a, b):
        raise ValueError(f"window [{window.start}, {window.stop}) is not the plan's "
                         f"[{a}, {b}) for the outputs [{o0}, {o1})")
    return wrapper.sample(data)[..., o0 - a:o1 - a]


def sample_time_sharded(wrapper, shard: TimeShard) -> TimeShard:
    """``wrapper.sample`` of a time-sharded signal: this rank's span of the
    output on the global output grid. Every rank of the shard's group must
    call it."""
    plan = time_plan(wrapper)
    length_out = wrapper.output_length(shard.length)
    keep = _keep(shard, length_out)
    window = _exchange(plan, shard, length_out)
    return shard.on_grid(span_sample(wrapper, plan, window, keep), length_out)


def sample_windows(wrapper, plan, x: torch.Tensor, ranks: int) -> torch.Tensor:
    """``wrapper.sample(x)`` put together from the windows that ``ranks``
    ranks of ``shard_time`` would run under ``plan``, all in this process
    (no collective): each window through ``span_sample``, the owned
    outputs concatenated."""
    T = x.shape[-1]
    step = -(-T // ranks)
    length_out = wrapper.output_length(T)
    parts = []
    for i in range(ranks):
        keep = min(i * step, length_out), min((i + 1) * step, length_out)
        if keep[1] > keep[0]:
            a, b = plan.window(T, keep)
            window = TimeShard(x[..., a:b], a, b, T, step, i, ranks)
            parts.append(span_sample(wrapper, plan, window, keep))
    return torch.cat(parts, dim=-1)


def _masked_stage(wrapper, idx: int, on: bool, shard: TimeShard, labels) -> TimeShard:
    """``chain.inference.masked_stage`` on a time-sharded signal: the model
    where ``labels[:, idx] > 0.5``, else the passthrough, causal-cropped on
    the global grid when the model shortens its output (output ``j`` is
    input ``j + T - 1 - T_out``, inside the TCN's halo). ``on``: some row
    selects the stage; when none does, the model does not run."""
    length_out = wrapper.output_length(shard.length)
    shift = shard.length - 1 - length_out if length_out < shard.length else 0
    if not on and not shift:
        return shard
    plan = time_plan(wrapper)
    o0, o1 = keep = _keep(shard, length_out)
    window = _exchange(plan, shard, length_out)
    data = window.data
    if o1 <= o0:
        return shard.on_grid(data.new_empty((*data.shape[:-1], 0)), length_out)
    y = data[..., o0 + shift - window.start:o1 + shift - window.start]
    if on:
        mask = labels[:, idx] > 0.5
        y = torch.where(mask[:, None, None], span_sample(wrapper, plan, window, keep), y)
    return shard.on_grid(y, length_out)


def run_time_sharded(chain, shard: TimeShard, labels=None):
    """``chain.run`` (``ChainInference``) of a time-sharded file: the labels
    from the classifier through its gather plan, so every rank holds the
    same; all ones under ``use_all_effect_models``; else the given ones.
    Then the masked stages in ``chain.effect_order``, each through its
    backbone's plan. Equals ``chain.remove`` of the whole file, whatever the
    chain's dispatch. Every rank of the shard's group must call it.
    -> (this rank's ``TimeShard`` of the output, labels)."""
    x = shard.data
    resolve_device(x.device)
    if chain.classifier is not None:  # its plan is the gather: the whole file
        whole = _exchange(time_plan(chain.classifier), shard, shard.length)
        labels = chain.detect(whole.data)
    if chain.use_all_effect_models:
        labels = torch.ones(x.shape[0], len(ALL_EFFECTS), device=x.device)
    if labels is None:
        raise ValueError("no classifier and no labels given")
    on = (labels > 0.5).any(dim=0).tolist()  # one readback of the replicated labels
    y = shard
    for wrapper, idx in chain._stages(chain.effect_order):
        y = _masked_stage(wrapper, idx, on[idx], y, labels)
    return y, labels
