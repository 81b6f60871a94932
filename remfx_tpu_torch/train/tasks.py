"""Training tasks: effect removal (RemFX) and effect classification.

Counterpart of ``remfx_tpu/train/tasks.py`` (reference remfx/models.py):

  * ``RemovalTask`` (``RemFX``, 152-256): AdamW (lr 1e-4, betas (0.95,
    0.999), eps 1e-6, wd 1e-3) + MultiStepLR x0.1 at 80%/95% of max_steps
    + the trainer's global-norm clip at 10; metrics SI-SDR and MR-STFT for
    output against target and input against target (``Input_*``).
  * ``ClassifierTask`` (``FXClassifier``, 423-592): AdamW (3e-4, wd 1e-3)
    + the clip; Cnn14 path = per-head BCE summed + per-effect binary
    accuracy + macro average; optional mixup (p=0.5, lambda ~ U(0.25,
    0.75) per example, labels OR-ed, models.py:393-420).

The optimizer is optax's chain held to optax's arithmetic:

  * ``clip_by_global_norm`` scales by ``max / norm`` only when ``norm >=
    max`` (optax's rule; ``torch.nn.utils.clip_grad_norm_`` always scales
    by ``max / (norm + 1e-6)`` clamped at 1);
  * ``torch.optim.AdamW`` over every parameter in one group (optax decays
    every leaf, biases and norm scales included), the same algebra as
    optax's ``adamw`` rounded in another order;
  * the LR schedule (``piecewise_constant_schedule`` at ``int(m *
    max_steps)``, m in (0.8, 0.95)) is ``MultiStepLR`` stepped once per
    optimizer update; ``max_steps <= 0`` is a constant LR;
  * ``accumulate_grad_batches = k`` is ``optax.MultiSteps``: the running
    mean of k micro-batch gradients, clipped and applied on the k-th.

``TrainState`` holds the module, the optimizer, the scheduler and the
counters (``step``: train steps taken, as flax's ``TrainState.step``;
``mini_step``: micro-batches accumulated, as MultiSteps' ``mini_step``).
Its ``state_dict`` is the whole state under the module's own names,
whatever the layout: a module sharded by FSDP2 gives its full tensors.

Data parallelism (``task.mesh``, set by ``train/loop.py``): each rank
takes its rows of the global batch (``rows``, a ``parallel.Rows``), and
the gradients are averaged over ``dp`` in one bucketed ``all_reduce``
before the MultiSteps mean, the clip and AdamW, in both precisions. A
module sharded over ``tp`` (FSDP2, ``parallel.shard_params_channels``)
has its gradients reduced by FSDP, the clip's norm reduced over the
shards, and bf16-mixed computed by FSDP's mixed-precision policy (the
same bf16 copies of the fp32 masters). Draws over the batch (mixup,
SpecAugment's masks, dropout) are made at the global batch's shape and
each rank keeps its rows, so that N ranks train as one device does.

bf16-mixed (``precision="bf16-mixed"``) is the JAX package's cast, not
``torch.autocast``: the parameters and ``x`` are cast to bf16 inside the
loss (``torch.func.functional_call`` on bf16 copies, so the gradients
reach the fp32 masters), the wrapper casts the target, and the norms run
on the bf16 activations as flax's do (in fp32 inside, ``models/
batchnorm.py``). The BatchNorm running statistics stay fp32; JAX rounds
the old ones to bf16 before it updates them.

A removal step is the span ``train.step`` (``utils/spans.py``), its phases
the spans ``train.forward``, ``train.backward``, ``train.update`` (with
``train.clip`` inside it) and ``train.metrics``; ``train.update`` covers the
classifier's update too.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from remfx_tpu_torch.losses import multi_resolution_stft_loss, si_sdr
from remfx_tpu_torch.parallel.mesh import Rows, all_reduce_mean_, split_batch
from remfx_tpu_torch.train.metrics import multilabel_f1
from remfx_tpu_torch.utils.crop import causal_crop
from remfx_tpu_torch.utils.device import cpu_bf16_convolutions
from remfx_tpu_torch.utils.spans import span

HALF_PRECISIONS = ("bf16", "bf16-mixed", "bf16-true")


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0
    mini_step: int = 0
    acc_grads: list | None = field(default=None, repr=False)

    def state_dict(self) -> dict:
        """The state with full tensors (a sharded module's are gathered:
        every rank takes part)."""
        opt = self.optimizer.state_dict()
        opt["state"] = {i: {k: _full(v) for k, v in st.items()}
                        for i, st in opt["state"].items()}
        return {
            "model": {k: _full(v) for k, v in self.model.state_dict().items()},
            "optimizer": opt,
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "step": self.step,
            "mini_step": self.mini_step,
            "acc_grads": (None if self.acc_grads is None
                          else [_full(a) for a in self.acc_grads]),
        }

    def load_state_dict(self, sd: dict):
        """``sd`` of ``state_dict``, into this state's layout."""
        own = self.model.state_dict()
        self.model.load_state_dict({k: _like(v, own.get(k)) for k, v in sd["model"].items()},
                                   strict=True)
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        opt = dict(sd["optimizer"])
        opt["state"] = {i: {k: _like(v, params[i]) for k, v in st.items()}
                        for i, st in opt["state"].items()}
        self.optimizer.load_state_dict(opt)
        if self.scheduler is not None and sd["scheduler"] is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
        self.mini_step = int(sd["mini_step"])
        if sd["acc_grads"] is not None:
            trained = [p for p in self.model.parameters() if p.requires_grad]
            self.acc_grads = [_like(a, p) for a, p in zip(sd["acc_grads"], trained)]


def _full(t):
    """A ``DTensor``'s full value (a collective), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _like(value, ref):
    """A full tensor laid out as ``ref`` (a ``DTensor`` of its shape gets
    this rank's shard), on ``ref``'s device."""
    if isinstance(ref, DTensor) and value.shape == ref.shape:
        return distribute_tensor(value.to(ref.device_mesh.device_type), ref.device_mesh,
                                 ref.placements)
    if isinstance(ref, torch.Tensor) and value.dim() > 0:
        return value.to(ref.device)
    return value


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm); of
    ``DTensor``s, the sum over every shard."""
    tensors = list(tensors)
    sq = sum(torch.sum(_local(t).float() * _local(t).float()) for t in tensors)
    sharded = [t for t in tensors if isinstance(t, DTensor)]
    if sharded:
        mesh, placements = sharded[0].device_mesh, sharded[0].placements
        for dim, placement in enumerate(placements):
            if placement.is_shard():
                dist.all_reduce(sq, group=mesh.get_group(dim))
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g`` stays when the global norm
    is below ``max_norm``, else becomes ``(g / norm) * max_norm``. Returns
    the norm; no host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in map(_local, grads):
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


def milestones(max_steps, fractions=(0.8, 0.95)) -> list[int]:
    """The schedule's boundaries: ``int(m * max_steps)``, each once (a
    boundary met twice decays once, as optax's dict of boundaries)."""
    return sorted({int(m * max_steps) for m in fractions})


def multistep_adamw(params, lr: float, max_steps, beta1: float = 0.95,
                    beta2: float = 0.999, eps: float = 1e-6,
                    weight_decay: float = 1e-3, gamma: float = 0.1):
    """-> (AdamW, MultiStepLR or None): reference remfx/models.py:185-206."""
    opt = torch.optim.AdamW(list(params), lr=lr, betas=(beta1, beta2), eps=eps,
                            weight_decay=weight_decay)
    if max_steps is None or max_steps <= 0:  # -1 = unlimited: constant LR
        return opt, None
    return opt, torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones(max_steps), gamma=gamma)


class _Optimizing:
    """The optimizer update shared by both tasks: MultiSteps accumulation,
    the clip, AdamW and the schedule."""

    accumulate_grad_batches = 1
    gradient_clip_val = 10.0
    mesh = None  # the (dp, tp) DeviceMesh of data parallelism, or None

    @property
    def sharded(self) -> bool:
        """Whether the parameters are sharded over ``tp`` (FSDP2)."""
        return self.mesh is not None and self.mesh.size(1) > 1

    def _rows(self, batch, rows):
        return Rows(0, batch[0].shape[0], batch[0].shape[0]) if rows is None else rows

    def _apply_gradients(self, state: TrainState):
        with span("train.update"):
            params = [p for p in state.model.parameters() if p.requires_grad]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if self.mesh is not None and not self.sharded:
                all_reduce_mean_(grads, self.mesh.get_group("dp"))
            k = self.accumulate_grad_batches
            state.step += 1
            if k > 1:
                if state.acc_grads is None:
                    state.acc_grads = [torch.zeros_like(p) for p in params]
                n = state.mini_step
                with torch.no_grad():
                    for acc, g in zip(state.acc_grads, grads):
                        acc.add_((g - acc) / (n + 1))
                state.mini_step = (n + 1) % k
                if n != k - 1:
                    state.optimizer.zero_grad(set_to_none=True)
                    return
                grads = [a.clone() for a in state.acc_grads]
                for acc in state.acc_grads:
                    acc.zero_()
            with span("train.clip"):
                clip_by_global_norm_(grads, self.gradient_clip_val)
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            if state.scheduler is not None:
                state.scheduler.step()


class _LossCall(nn.Module):
    """``wrapper.loss_and_output`` as a module's forward, for
    ``torch.func.functional_call`` with bf16 copies of the parameters; with
    ``backward``, the backward pass runs inside the call too, so that a
    block checkpointed by ``remat`` recomputes with the same bf16 copies."""

    def __init__(self, wrapper, backward: bool = False):
        super().__init__()
        self.w = wrapper
        self.backward = backward

    def forward(self, batch):
        return _forward_backward(self.w, batch, self.backward)


def _forward_backward(wrapper, batch, backward: bool):
    """``wrapper.loss_and_output(batch)``, then with ``backward`` the
    backward pass, each a span of the training step."""
    if not backward:
        return wrapper.loss_and_output(batch)
    with span("train.forward"):
        loss, output = wrapper.loss_and_output(batch)
    with span("train.backward"):
        loss.float().backward()
    return loss, output


# ------------------------------------------------------------------ removal


class RemovalTask(_Optimizing):
    """RemFX trainer around a ``ModelWrapper`` (built on its device)."""

    def __init__(
        self,
        wrapper,
        lr: float = 1e-4,
        lr_beta1: float = 0.95,
        lr_beta2: float = 0.999,
        lr_eps: float = 1e-6,
        lr_weight_decay: float = 1e-3,
        max_steps: int = 50000,
        gradient_clip_val: float = 10.0,
        sample_rate: int = 48000,
        accumulate_grad_batches: int = 1,
        precision: str = "32",
    ):
        self.wrapper = wrapper
        self.sample_rate = sample_rate
        self.precision = str(precision)
        # Lightning semantics: max_steps and the LR milestones count
        # OPTIMIZER steps; fit() consumes accumulate_grad_batches
        # micro-batches per counted step (train/loop.py)
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.gradient_clip_val = float(gradient_clip_val)
        self._opt_args = dict(lr=lr, max_steps=max_steps, beta1=lr_beta1,
                              beta2=lr_beta2, eps=lr_eps,
                              weight_decay=lr_weight_decay)

    def init_state(self) -> TrainState:
        opt, sched = multistep_adamw(self.wrapper.parameters(), **self._opt_args)
        return TrainState(self.wrapper, opt, sched)

    @property
    def _half(self):
        return self.precision in HALF_PRECISIONS

    def _metrics(self, output, x, y, loss, prefix):
        target = y
        if output.shape[-1] < y.shape[-1]:
            target = causal_crop(y, output.shape[-1])
        return {
            f"{prefix}_loss": loss,
            f"{prefix}_SISDR": si_sdr(output, target),
            f"{prefix}_STFT": multi_resolution_stft_loss(output, target),
            "Input_SISDR": si_sdr(x, y),
            "Input_STFT": multi_resolution_stft_loss(x, y),
        }

    def _loss_and_output(self, x, y, backward: bool = False):
        """-> (loss, output); with ``backward``, after the backward pass. In
        bf16 on the CPU, forward and backward run under
        ``cpu_bf16_convolutions``, the recomputation of checkpointed
        blocks with them."""
        with cpu_bf16_convolutions(x, self._half):
            return self._loss_and_output_in(x, y, backward)

    def _loss_and_output_in(self, x, y, backward: bool):
        if not self._half or self.sharded:  # FSDP's policy makes the bf16 copies
            return _forward_backward(
                self.wrapper, (x.to(torch.bfloat16) if self._half else x, y), backward)
        call = _LossCall(self.wrapper, backward)
        half = {f"w.{k}": v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                for k, v in self.wrapper.named_parameters()}
        return torch.func.functional_call(call, half, ((x.to(torch.bfloat16), y),),
                                          strict=False)

    def train_step(self, state: TrainState, batch, rows: Rows | None = None):
        """One micro-batch (this rank's ``rows`` of it under data
        parallelism): forward, backward and (every k-th) the update.
        -> (state, metrics), the metrics as 0-d tensors on the device."""
        x, y = batch
        with span("train.step"):
            self.wrapper.train()
            with split_batch(self._rows(batch, rows)):
                loss, output = self._loss_and_output(x, y, backward=True)
            loss = loss.float()
            self._apply_gradients(state)
            with torch.no_grad(), span("train.metrics"):
                metrics = self._metrics(output.detach().float(), x, y, loss.detach(), "train")
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, prefix: str = "valid"):
        x, y = batch
        self.wrapper.eval()
        loss, output = self._loss_and_output(x, y)
        return self._metrics(output.float(), x, y, loss.float(), prefix)


# --------------------------------------------------------------- classifier


def mixup_from_draws(x, y, lam, index, do):
    """Mixup's arithmetic given its draws: ``lam (B, 1, 1)``, the
    permutation ``index (B,)`` and the coin ``do`` (0-d bool)."""
    mixed_x = torch.where(do, lam * x + (1 - lam) * x[index], x)
    mixed_y = torch.where(do, torch.logical_or(y > 0, y[index] > 0).to(y.dtype), y)
    return mixed_x, mixed_y


def mixup(generator, x, y):
    """Reference mixup (remfx/models.py:393-420): with p=0.5 per batch,
    lambda ~ U(0.25, 0.75) per example, labels OR-ed. Draws on the CPU
    from ``generator``."""
    B = x.shape[0]
    lam = 0.25 + 0.5 * torch.rand(B, 1, 1, generator=generator)
    index = torch.randperm(B, generator=generator)
    do = torch.rand((), generator=generator) > 0.5
    dev = x.device
    return mixup_from_draws(x, y, lam.to(dev), index.to(dev), do.to(dev))


def _gather(t, group):
    """The ranks' equal parts of ``t`` over ``group``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _bce(probs, targets, eps=1e-7):
    p = torch.clamp(probs, eps, 1 - eps)
    return -torch.mean(targets * torch.log(p) + (1 - targets) * torch.log(1 - p))


class ClassifierTask(_Optimizing):
    """FXClassifier trainer.

    ``loss_type="bce"`` = the Cnn14 path (summed per-head BCE on sigmoid
    probs + per-effect accuracy); ``loss_type="ce"`` = the non-Cnn14 path
    (reference quirk #9: CrossEntropyLoss against multi-hot targets with
    optional label smoothing, metrics = multilabel F1 per class + macro;
    remfx/models.py:457-488,550-574). ``seed`` seeds the generator of
    mixup's and SpecAugment's draws; dropout draws from torch's default
    generator.
    """

    def __init__(
        self,
        network,
        lr: float = 3e-4,
        lr_weight_decay: float = 1e-3,
        use_mixup: bool = False,
        sample_rate: int = 48000,
        effects=("Reverb", "Chorus", "Delay", "Distortion", "Compressor"),
        loss_type: str = "bce",
        label_smoothing: float = 0.0,
        gradient_clip_val: float = 10.0,
        seed: int = 0,
    ):
        self.network = network
        self.use_mixup = use_mixup
        self.effects = effects
        self.loss_type = loss_type
        self.label_smoothing = label_smoothing
        # trainer.gradient_clip_val applies to the classifier too
        # (reference cfg/exp/5-5_full_cls.yaml:59)
        self.gradient_clip_val = float(gradient_clip_val)
        self.lr, self.lr_weight_decay = lr, lr_weight_decay
        self.generator = torch.Generator().manual_seed(int(seed))

    def init_state(self) -> TrainState:
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.AdamW(list(self.network.parameters()), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.lr_weight_decay)
        return TrainState(self.network, opt, None)

    def _loss_and_metrics(self, outputs, labels, prefix):
        metrics = {}
        if self.loss_type == "ce":
            # torch CE with soft (multi-hot) targets + label smoothing
            logits = outputs
            C = logits.shape[-1]
            t = labels * (1.0 - self.label_smoothing) + self.label_smoothing / C
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.mean(torch.sum(t * logp, dim=-1))
            probs = torch.sigmoid(logits)
            f1 = multilabel_f1(probs, labels)
            for i, name in enumerate(self.effects):
                metrics[f"{prefix}_f1_{name}"] = f1[i]
            metrics[f"{prefix}_loss"] = loss
            metrics[f"{prefix}_avg_acc"] = multilabel_f1(probs, labels, average="macro")
            return loss, metrics
        probs = outputs
        loss = 0.0
        accs = []
        for i, name in enumerate(self.effects):
            loss = loss + _bce(probs[:, i], labels[:, i])
            acc = ((probs[:, i] > 0.5) == (labels[:, i] > 0.5)).float().mean()
            metrics[f"{prefix}_{name}_acc"] = acc
            accs.append(acc)
        metrics[f"{prefix}_loss"] = loss
        metrics[f"{prefix}_avg_acc"] = torch.stack(accs).mean()
        return loss, metrics

    def train_step(self, state: TrainState, batch, rows: Rows | None = None):
        x, labels = batch
        rows = self._rows(batch, rows)
        if self.use_mixup:
            if rows.split:  # mix with the global batch, keep this rank's rows
                x, labels = (_gather(t, rows.group) for t in (x, labels))
            x, labels = mixup(self.generator, x, labels)
            if rows.split:
                x, labels = rows.take(x), rows.take(labels)
        self.network.train()
        with split_batch(rows):
            probs = self.network(x, generator=self.generator)
        loss, metrics = self._loss_and_metrics(probs, labels, "train")
        loss.backward()
        self._apply_gradients(state)
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, prefix: str = "valid"):
        x, labels = batch
        self.network.eval()
        _, metrics = self._loss_and_metrics(self.network(x), labels, prefix)
        return metrics
