"""Train steps, batch statistics and time-sharded inference on a mesh: the
functions that ``parallel.launch.spawn`` runs in each rank to hold N ranks
against one process (``tests/test_torch_parallel*.py``,
``tests/test_torch_sequence.py`` and ``chip_smoke.py``).

Each takes numpy inputs (the weights as a state dict, the global batch)
and returns numpy or plain values. Called in a process group, it builds
the ``(dp, tp)`` mesh over every rank and takes this rank's rows; called
outside one, it is the one-process run of the same step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.models.batchnorm import BatchNorm2d
from remfx_tpu_torch.parallel.mesh import (batch_rows, gather_time, make_mesh, mesh_shape,
                                           shard_batch, shard_time, split_batch)
from remfx_tpu_torch.parallel.sequence import (halo_exchange, run_time_sharded,
                                               sample_time_sharded)
from remfx_tpu_torch.train.loop import _mean_over_ranks, _shard_state, build_mesh
from remfx_tpu_torch.train.tasks import ClassifierTask, RemovalTask
from remfx_tpu_torch.utils.device import resolve_device


def _device(device_type: str) -> torch.device:
    if device_type == "cuda" and dist.is_initialized():
        return resolve_device(torch.device("cuda", torch.cuda.current_device()))
    return resolve_device(device_type)


def _mesh(tp: int):
    return make_mesh(tp=tp) if dist.is_initialized() else None


def _numpy(sd: dict) -> dict | None:
    """Rank 0's state dict as numpy (every rank gathered it)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _load(module, state_dict: dict, device):
    module.load_state_dict({k: torch.as_tensor(v, device=device)
                            for k, v in state_dict.items()}, strict=True)


def _steps(task, state, batch, rows, steps: int) -> dict:
    """-> {"losses": the global batch's train loss per step, "state_dict":
    the model's after the steps, "exp_avg": Adam's first moment of each
    parameter, in order (rank 0's; the others' None)}."""
    losses = []
    for _ in range(steps):
        state, metrics = task.train_step(state, batch, rows)
        losses.append(_mean_over_ranks(metrics)["train_loss"])
    sd = state.state_dict()
    moments = _numpy({str(i): st["exp_avg"] for i, st in sd["optimizer"]["state"].items()})
    return {"losses": losses, "state_dict": _numpy(sd["model"]),
            "exp_avg": None if moments is None else [moments[str(i)] for i in range(len(moments))]}


def removal_steps(name: str, network: dict, state_dict: dict, x, y, steps: int = 1,
                  tp: int = 1, precision: str = "32", device_type: str = "cpu",
                  max_steps: int = 100) -> dict:
    """``steps`` RemovalTask steps of model ``name`` from ``state_dict`` (the
    module's) on the global batch ``(x, y)``. -> ``_steps``' dict, with
    "mesh" ({"dp", "tp"} or None) and "sharded" (over tp)."""
    device = _device(device_type)
    wrapper = make_model(name, device=device, **network)
    _load(wrapper.module, state_dict, device)
    task = RemovalTask(wrapper, max_steps=max_steps, precision=precision)
    state = task.init_state()
    mesh = _mesh(tp)
    if mesh is not None:
        state = _shard_state(task, state, mesh)
    rows = batch_rows(len(x), mesh)
    batch = tuple(rows.take(torch.as_tensor(a)).to(device) for a in (x, y))
    return {**_steps(task, state, batch, rows, steps),
            "mesh": None if mesh is None else mesh_shape(mesh), "sharded": task.sharded}


def classifier_steps(network: dict, state_dict: dict, x, labels, steps: int = 1,
                     seed: int = 0, mixup: bool = True, device_type: str = "cpu") -> dict:
    """``steps`` ClassifierTask steps of a Cnn14 (``make_cnn14(**network)``)
    from ``state_dict`` on the global batch ``(x, labels)``; mixup and
    SpecAugment draw from ``seed``, dropout from torch's default generator
    seeded with it. -> as ``removal_steps``."""
    device = _device(device_type)
    torch.manual_seed(seed)
    net = make_cnn14(device=device, **network)
    _load(net, state_dict, device)
    task = ClassifierTask(net, use_mixup=mixup, seed=seed)
    state = task.init_state()
    mesh = _mesh(1)
    if mesh is not None:
        state = _shard_state(task, state, mesh)
    rows = batch_rows(len(x), mesh)
    batch = tuple(rows.take(torch.as_tensor(a)).to(device) for a in (x, labels))
    return _steps(task, state, batch, rows, steps)


def batchnorm_train(state_dict: dict, x, device_type: str = "cpu") -> dict:
    """One train-mode ``BatchNorm2d`` forward and backward (of the sum of
    the output times a fixed ramp) on this rank's rows of ``x (B, C, H,
    W)``. -> {"y": this rank's output rows, "rows": [start, stop),
    "running_mean", "running_var", "grad": the input gradient of those
    rows, "weight_grad": the weight's gradient summed over the ranks}."""
    device = _device(device_type)
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).to(device)
    _load(bn, state_dict, device)
    mesh = _mesh(1)
    rows = batch_rows(len(x), mesh)
    xb = rows.take(torch.as_tensor(x)).to(device).requires_grad_(True)
    ramp = torch.linspace(-1, 1, xb[0].numel(), device=device).view_as(xb[0])
    with split_batch(rows):
        y = bn.train()(xb)
    (y * ramp).sum().backward()
    wg = bn.weight.grad.clone()
    if mesh is not None:
        dist.all_reduce(wg)
    return {"y": y.detach().cpu().numpy(), "rows": [rows.start, rows.stop],
            "running_mean": bn.running_mean.cpu().numpy(),
            "running_var": bn.running_var.cpu().numpy(),
            "grad": xb.grad.cpu().numpy(), "weight_grad": wg.cpu().numpy()}


def mesh_probe(cfg: dict, sizes=(11, 1, 8)) -> dict:
    """``build_mesh(cfg)`` in this rank: its shape, size and this rank's
    coordinates, ``shard_batch`` of an 8-row batch, and the rows it keeps of
    batches of ``sizes`` (strict and not)."""
    mesh = build_mesh(cfg)
    out = {"shape": mesh_shape(mesh), "size": mesh.mesh.numel(),
           "dp_rank": mesh.get_local_rank("dp"), "tp_rank": mesh.get_local_rank("tp"),
           "shard_batch": [t.tolist() for t in
                           shard_batch((torch.arange(8), torch.arange(8) * 10), mesh)]}
    for strict in (True, False):
        out[f"strict={strict}"] = {n: [r.start, r.stop, r.total, r.split] for n in sizes
                                   for r in [batch_rows(n, mesh, strict)]}
    return out


def _removal_model(spec, device):
    """``(model name, network, state dict or None)`` -> its wrapper, with
    the state dict's weights or torch's seeded initialisation."""
    name, network, state_dict = spec
    wrapper = make_model(name, device=device, **network)
    if state_dict is not None:
        _load(wrapper.module, state_dict, device)
    return wrapper


def time_sharded_samples(models: list, x, cases, device_type: str = "cpu") -> list:
    """The removal ``models`` (``(name, network, state dict or None)``,
    built in order after ``torch.manual_seed(0)``) on time-sharded inputs:
    for each ``(model index, T)`` of ``cases``, the first ``T`` samples of
    ``x`` split over every rank, ``gather_time(sample_time_sharded(...))``
    and, in this rank too, ``sample`` of the whole input. -> per case
    {"sharded", "whole", "span": [start, stop) of this rank's output}."""
    device = _device(device_type)
    torch.manual_seed(0)
    wrappers = [_removal_model(spec, device) for spec in models]
    mesh = make_mesh()
    out = []
    for k, T in cases:
        xt = torch.as_tensor(x[..., :T], device=device)
        y = sample_time_sharded(wrappers[k], shard_time(xt, mesh))
        out.append({"sharded": gather_time(y).cpu().numpy(),
                    "whole": wrappers[k].sample(xt).cpu().numpy(),
                    "span": [y.start, y.stop]})
    return out


def time_sharded_chain(slots: dict, cases: list, classifier: dict | None = None,
                       device_type: str = "cpu") -> list:
    """``run_time_sharded`` of a ``ChainInference`` over the removal
    ``slots`` ({effect class name: (name, network, state dict or None)},
    built in order after ``torch.manual_seed(0)``, then the Cnn14 of
    ``classifier``'s network, if any) for each ``(x, labels)`` of
    ``cases``: labels an array (oracle), ``"detect"`` (the classifier) or
    ``"all"`` (``use_all_effect_models``). -> per case {"sharded": the
    gathered output, "labels", "whole" and "whole_labels": ``run`` of the
    whole input in this rank, "span"}."""
    device = _device(device_type)
    torch.manual_seed(0)
    models = {k: _removal_model(spec, device) for k, spec in slots.items()}
    cls = None if classifier is None else make_cnn14(device=device, **classifier)
    mesh = make_mesh()
    out = []
    for x, labels in cases:
        mode = labels if isinstance(labels, str) else "oracle"
        chain = ChainInference(models, 48000, classifier=cls if mode == "detect" else None,
                               use_all_effect_models=mode == "all")
        given = None if mode != "oracle" else torch.as_tensor(labels, device=device)
        xt = torch.as_tensor(x, device=device)
        y, got = run_time_sharded(chain, shard_time(xt, mesh), given)
        whole, whole_labels = chain.run(xt, given)
        out.append({"sharded": gather_time(y).cpu().numpy(), "labels": got.cpu().numpy(),
                    "whole": whole.cpu().numpy(), "whole_labels": whole_labels.cpu().numpy(),
                    "span": [y.start, y.stop]})
    return out


def time_shard_contract() -> dict:
    """``shard_time`` of nested lists (``range(16)``) over a ``(dp, tp 2)``
    mesh: its shape, this rank's span and the gathered whole; then, over a
    mesh of every rank on ``dp``, the ``ValueError`` of a halo one sample
    longer than a span, from the left and from the right."""
    mesh = make_mesh(tp=2)
    shard = shard_time([[list(range(16))]], mesh)
    whole = gather_time(shard)
    out = {"dp_rank": mesh.get_local_rank("dp"), "tp_rank": mesh.get_local_rank("tp"),
           "span": [shard.start, shard.stop], "data": shard.data.tolist(),
           "whole": whole.tolist(), "shape": list(whole.shape), "errors": []}
    shard = shard_time(torch.arange(16.0)[None], make_mesh())
    for left, right in ((shard.step + 1, 0), (0, shard.step + 1)):
        try:
            halo_exchange(shard, left, right)
        except ValueError as e:
            out["errors"].append(str(e))
    return out
