"""Checkpoints of training runs, torch-native.

Counterpart of ``remfx_tpu/train/checkpoint.py`` (Lightning
ModelCheckpoint, reference cfg/config.yaml:31-40): monitor a metric, keep
top-1 ("best") and always save "last"; resume through an explicit path
or, with ``auto_resume``, from the newest run in ``logs_dir``. The layout
is the JAX package's:

    {logs_dir}/ckpts/{time stamp}/
        best/  last/  best_meta.json  last_meta.json (step, epoch, run_tag)

where ``best`` and ``last`` are directories; here each holds
``state.pt``, a ``torch.save`` of ``TrainState.state_dict()`` (the
model's, the optimizer's and the scheduler's state dicts and the
counters). A save replaces the live directory through ``name.tmp`` and
``name.old`` renames, so a crash never leaves ``name`` half written; the
``.tmp`` directory is itself renamed into place only once complete.

Under data parallelism every rank gathers the state (the full tensors of
a module sharded by FSDP2, under its own names: ``TrainState.state_dict``)
and rank 0 alone writes (``writer``); the others wait for the files, so
``state.pt`` is one device's and a run resumes on any number of devices.

The JAX package's orbax checkpoints (the vendored ``ckpts/`` and its
training runs) are read without JAX by ``compat/ocdbt.py``:
``restore_tree`` gives a directory's raw tree; ``load_trained_wrapper``
and ``load_trained_classifier`` build the vendored models with their
weights carried over by ``compat/from_jax.py``; ``warm_start`` also takes
an orbax directory as its donor. The reference's torch ``.ckpt`` files are
read by ``compat/torch_import.py`` and loaded by ``load_torch_checkpoint``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from remfx_tpu_torch.compat import from_jax, ocdbt, torch_import

STATE_FILE = "state.pt"


def _write(directory: Path, state_dict: dict) -> None:
    """``state.pt`` into ``directory``, which appears only when complete."""
    partial = directory.with_name(directory.name + ".partial")
    if partial.exists():
        shutil.rmtree(partial)
    partial.mkdir(parents=True)
    torch.save(state_dict, partial / STATE_FILE)
    partial.rename(directory)


class CheckpointManager:
    """``writer``: whether this process writes (rank 0 of a process group;
    every rank takes part in a save, and returns once the files exist)."""

    def __init__(self, ckpt_dir: str, monitor: str = "valid_loss", mode: str = "min",
                 writer: bool = True):
        self.dir = Path(ckpt_dir).resolve()
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best = None

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def _save(self, name: str, state, meta: dict):
        state_dict = state.state_dict()  # a collective under FSDP2
        if self.writer:
            # write beside the live checkpoint, then swap by renames, so a
            # preemption mid-save never leaves `name` missing or half-written
            final = self.dir / name
            tmp = self.dir / f"{name}.tmp"
            old = self.dir / f"{name}.old"
            for p in (tmp, old):
                if p.exists():
                    shutil.rmtree(p)
            _write(tmp, state_dict)
            if final.exists():
                final.rename(old)
            tmp.rename(final)
            if old.exists():
                shutil.rmtree(old)
            (self.dir / f"{name}_meta.json").write_text(json.dumps(meta))
        if dist.is_initialized():
            dist.barrier()

    def save_last(self, state, step: int, epoch: int = 0,
                  run_tag: str | None = None):
        self._save("last", state, {"step": step, "epoch": epoch, "run_tag": run_tag})

    def maybe_save_best(self, state, metrics: dict, step: int) -> bool:
        if self.monitor not in metrics:
            return False
        value = float(metrics[self.monitor])
        if self._is_better(value):
            self.best = value
            self._save("best", state, {"step": step, self.monitor: value})
            return True
        return False

    def restore(self, state, name: str = "best"):
        return restore_from(str(self.dir / name), state)


def find_latest_run(logs_dir: str):
    """Newest timestamped ckpt dir under ``logs_dir/ckpts`` that holds a
    completed "last" save, or None (preemption auto-resume)."""
    root = Path(logs_dir) / "ckpts"
    if not root.is_dir():
        return None
    runs = sorted(
        (d for d in root.iterdir() if (d / "last_meta.json").is_file()),
        key=lambda d: d.name,
        reverse=True,
    )
    for d in runs:
        if _repair_last(d):
            return d
    return None


def _repair_last(run_dir: Path) -> bool:
    """Finish an interrupted `last` swap (see CheckpointManager._save):
    prefer a completed `.tmp` (newer), fall back to `.old` (one save
    stale), and report whether a usable `last` exists."""
    last = run_dir / "last"
    if not last.is_dir():
        for cand in (run_dir / "last.tmp", run_dir / "last.old"):
            if cand.is_dir():
                cand.rename(last)
                break
    return last.is_dir()


def read_state(path: str, device=None) -> dict:
    """The raw state dict of the checkpoint directory ``path``."""
    return torch.load(Path(path) / STATE_FILE, map_location=device,
                      weights_only=True)


def restore_from(path: str, state):
    """Restore ``state`` (a ``TrainState``) in place from the checkpoint
    directory ``path``; returns it."""
    device = next(state.model.parameters()).device
    state.load_state_dict(read_state(path, device))
    return state


def restore_tree(path) -> dict:
    """The raw tree of the JAX package's orbax checkpoint directory
    ``path`` (numpy leaves; bfloat16 as ``ocdbt.Bfloat16Bits``)."""
    return ocdbt.restore_tree(Path(path))


def jax_variables(raw: dict) -> dict:
    """``params`` (bfloat16 upcast to fp32, as the JAX loaders do) and, where
    the checkpoint has them, ``batch_stats`` of a restored tree."""
    variables = {"params": _map_leaves(ocdbt.upcast_bfloat16, raw["params"])}
    if raw.get("batch_stats") is not None:
        variables["batch_stats"] = raw["batch_stats"]
    return variables


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _family(net: torch.nn.Module):
    """``(family, bridge)`` of a port network (a wrapper's module, or
    Cnn14): its torch checkpoint family (``compat/torch_import.py``) and
    its JAX weight bridge (``compat/from_jax.py``)."""
    from remfx_tpu_torch.models import TCN, Cnn14, DCUNet, DPTNet, HDemucs, UMXSeparator

    families = ((TCN, "tcn", from_jax.tcn_state_dict),
                (HDemucs, "demucs", from_jax.demucs_state_dict),
                (DCUNet, "dcunet", from_jax.dcunet_state_dict),
                (Cnn14, "cnn14", from_jax.cnn14_state_dict),
                (UMXSeparator, "umx", from_jax.umx_state_dict),
                (DPTNet, "dptnet", from_jax.dptnet_state_dict))
    for cls, kind, bridge in families:
        if isinstance(net, cls):
            return kind, bridge
    raise NotImplementedError(f"no weight bridge for {type(net).__name__}")


def _network(model: torch.nn.Module) -> torch.nn.Module:
    from remfx_tpu_torch.models import ModelWrapper

    return model.module if isinstance(model, ModelWrapper) else model


def state_dict_from_jax(model: torch.nn.Module, variables: dict) -> dict:
    """A JAX variables tree -> ``model``'s state dict, through the bridge of
    ``compat/from_jax.py`` that matches the model (a removal model's
    ``ModelWrapper`` takes its module's, under ``module.``)."""
    inner = _network(model)
    sd = _family(inner)[1](variables)
    if inner is not model:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


def load_torch_checkpoint(path, model: torch.nn.Module) -> str:
    """The weights of the torch ``.ckpt`` file ``path`` (imported by
    ``compat/torch_import.py``) into ``model`` (a ``ModelWrapper`` or
    Cnn14), whose family the file must hold; a DCUNet's norm must be the
    file's too. BatchNorm counters the file lacks start at 0; anything
    else missing or extra raises (``strict=True``). Returns the family."""
    net = _network(model)
    want = _family(net)[0]
    kind, sd = torch_import.import_torch_checkpoint(path)
    if kind != want:
        raise ValueError(f"{Path(path)} holds a {kind} checkpoint; the model is {want}")
    own = net.state_dict()
    norm = torch_import.detect_dcunet_norm_type
    if kind == "dcunet" and norm(sd) != norm(own):
        raise ValueError(f"{Path(path)} holds a DCUNet with norm_type {norm(sd)!r}; "
                         f"the model has {norm(own)!r}")
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v)
    net.load_state_dict(sd, strict=True)
    return kind


def _hparams(ckpt_dir: Path) -> dict:
    return json.loads((ckpt_dir / "hparams.json").read_text())


def load_trained_wrapper(ckpt_dir, device=None, **network_overrides):
    """A vendored trained removal checkpoint (``hparams.json`` and either
    a params-only ``variables/`` orbax directory or a full TrainState in
    ``best/``, of which only ``params`` and ``batch_stats`` are taken) ->
    ``(effect, wrapper)``, the wrapper on ``device`` (the card unless
    given) with the checkpoint's weights. Counterpart of
    ``remfx_tpu/train/checkpoint.py:load_trained_wrapper``;
    ``network_overrides`` change the network config of ``hparams.json``
    (e.g. ``niter=1``, the Wiener EM post-filter of the trained UMX)."""
    from remfx_tpu_torch.models import make_model

    d = Path(ckpt_dir)
    hp = _hparams(d)
    effects = hp.get("effects_to_remove") or []
    if len(effects) != 1:
        raise ValueError(f"expected single-effect ckpt, got {effects}")
    m = hp["model"]
    net_cfg = {**m.get("network", {}), **network_overrides}
    wrapper = make_model(m["name"], sample_rate=hp["sample_rate"], device=device,
                         **net_cfg)
    src = d / "variables" if (d / "variables").is_dir() else d / "best"
    variables = jax_variables(restore_tree(src))
    wrapper.load_state_dict(state_dict_from_jax(wrapper, variables), strict=True)
    return effects[0], wrapper.eval()


def load_trained_classifier(ckpt_dir, device=None, **network_overrides):
    """A vendored trained classifier checkpoint (``task: classifier`` in
    its ``hparams.json``, weights in ``variables/``) -> the port's Cnn14 on
    ``device`` with its weights. Counterpart of
    ``remfx_tpu/train/checkpoint.py:load_trained_classifier``."""
    from remfx_tpu_torch.models import make_cnn14

    d = Path(ckpt_dir)
    hp = _hparams(d)
    m = hp["model"]
    if m.get("task") != "classifier":
        raise ValueError(f"not a classifier ckpt: {ckpt_dir}")
    net_cfg = {**m.get("network", {}), **network_overrides}
    net = make_cnn14(num_classes=hp.get("num_classes", 5),
                     sample_rate=hp["sample_rate"], device=device, **net_cfg)
    variables = jax_variables(restore_tree(d / "variables"))
    net.load_state_dict(state_dict_from_jax(net, variables), strict=True)
    return net.eval()


def warm_start(path: str, state):
    """Fine-tuning init from a donor checkpoint: the donor's parameters and
    buffers (BatchNorm statistics) in ``state``'s dtypes, with the
    optimizer, the schedule and the counters left fresh. The donor is a
    port checkpoint directory (``state.pt``) or an orbax directory of the
    JAX package (``_METADATA``: a run's ``best``/``last`` or a vendored
    ``variables``), whose ``params`` and ``batch_stats`` are carried over
    by ``compat/from_jax.py``."""
    device = next(state.model.parameters()).device
    if (Path(path) / "_METADATA").is_file():
        donor = state_dict_from_jax(state.model, jax_variables(restore_tree(path)))
    else:
        donor = read_state(path, device)["model"]
    own = state.model.state_dict()
    state.model.load_state_dict(
        {k: v.to(own[k].dtype) for k, v in donor.items()}, strict=True)
    return state
