"""Build a ChainInference from a chain-experiment config.

Counterpart of ``remfx_tpu/chain/build.py`` (the cfg/exp/
remfx_{oracle,detect,all}.yaml surface). Each slot of ``cfg["ckpts"]``
is a removal model and its weights:

* a ``ckpt_path`` that holds ``hparams.json`` is a vendored checkpoint
  (``ckpts/<name>/``): its hparams define the model, whatever the slot's
  ``model`` entry says, and its effect must be the slot's;
* any other existing directory is an orbax checkpoint of the JAX
  package, restored into the model the slot names;
* a file is a torch ``.ckpt`` in the reference's layout (its published
  checkpoints), imported by ``compat/torch_import.py`` into the model
  that the slot's ``model`` / ``network`` config builds, which must be
  of the file's family. The file carries no wrapper option: HDemucs'
  residual wrapper comes from ``identity_init`` in the slot's network
  config, as in the JAX package;
* a missing checkpoint is an error, unless ``REMFX_ALLOW_RANDOM_CKPT=1``,
  for smoke runs that mean to use random weights.

The classifier (``cfg["classifier"]``, ``cfg["classifier_ckpt"]``)
follows the same rules. Random weights are torch's default
initialisation under seeds drawn, one per model in config order, from a
``torch.Generator`` seeded with ``cfg["seed"]``; the process's own random
state is left as it was. Everything is built on ``device``: the card
unless the caller names another.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from remfx_tpu_torch import EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.train.checkpoint import (jax_variables, load_torch_checkpoint,
                                              load_trained_classifier,
                                              load_trained_wrapper, restore_tree,
                                              state_dict_from_jax)
from remfx_tpu_torch.utils.device import resolve_device
from remfx_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _load_variables(ckpt_path: str, model: torch.nn.Module, what: str):
    """The weights of a torch ``.ckpt`` file or an orbax directory into
    ``model``."""
    p = Path(ckpt_path)
    if p.is_file():
        kind = load_torch_checkpoint(p, model)
        log.info("imported torch checkpoint %s (%s) for %s", p, kind, what)
        return
    model.load_state_dict(state_dict_from_jax(model, jax_variables(restore_tree(p))),
                          strict=True)
    log.info("loaded %s from %s", what, p)


def _seeded(seeds: torch.Generator, build):
    """``build()`` under the next seed of ``seeds``, leaving the process's
    random state as it was."""
    seed = int(torch.randint(2**62, (1,), generator=seeds))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _missing(ckpt_path, what: str):
    if os.environ.get("REMFX_ALLOW_RANDOM_CKPT") == "1":
        log.warning("checkpoint %s missing for %s — using random init",
                    ckpt_path, what)
        return
    raise FileNotFoundError(
        f"checkpoint {ckpt_path} missing for {what}; give a vendored "
        "ckpts/<name>/ directory, or set REMFX_ALLOW_RANDOM_CKPT=1 for a "
        "random-weights smoke run")


def build_chain(cfg: dict, example_x=None, device=None) -> ChainInference:
    """The chain of ``cfg`` on ``device`` (the card unless given).
    ``example_x`` is the JAX signature's init example; torch modules
    need none, so it is not read."""
    from remfx_tpu_torch.config.experiments import MODEL_CONFIGS

    device = resolve_device(device)
    seeds = torch.Generator().manual_seed(int(cfg["seed"]))
    models = {}
    for class_name, spec in cfg.get("ckpts", {}).items():
        model_name = spec["model"] if isinstance(spec["model"], str) else (
            spec["model"].get("name"))
        net_cfg = {}
        if isinstance(spec["model"], dict):
            net_cfg = spec["model"].get("network", {})
        if model_name in MODEL_CONFIGS and not net_cfg:
            net_cfg = MODEL_CONFIGS[model_name].get("network", {})
            base_name = MODEL_CONFIGS[model_name]["name"]
        else:
            base_name = model_name
        ckpt_path = spec.get("ckpt_path")
        if ckpt_path and Path(ckpt_path, "hparams.json").is_file():
            effect, wrapper = load_trained_wrapper(ckpt_path, device=device)
            want = EFFECT_CLASS_NAMES.get(class_name)
            if want is not None and effect != want:
                raise ValueError(
                    f"vendored ckpt {ckpt_path} removes {effect!r} but is "
                    f"mapped to {class_name} ({want!r})")
            log.info("loaded vendored %s from %s", class_name, ckpt_path)
            models[class_name] = wrapper
            continue
        wrapper = _seeded(seeds, lambda: make_model(
            base_name, sample_rate=cfg["sample_rate"], device=device, **net_cfg))
        if ckpt_path and Path(ckpt_path).exists():
            _load_variables(ckpt_path, wrapper, class_name)
        else:
            _missing(ckpt_path, class_name)
        models[class_name] = wrapper

    classifier = None
    if cfg.get("classifier") is not None:
        ckpt = cfg.get("classifier_ckpt")
        if ckpt and Path(ckpt, "hparams.json").is_file():
            net = load_trained_classifier(ckpt, device=device)
            log.info("loaded vendored classifier from %s", ckpt)
            return _finish_chain(cfg, models, net)
        classifier = _seeded(seeds, lambda: make_cnn14(
            num_classes=cfg["num_classes"], sample_rate=cfg["sample_rate"],
            device=device, **cfg["classifier"].get("network", {})))
        if ckpt and Path(ckpt).exists():
            _load_variables(ckpt, classifier, "classifier")
        else:
            _missing(ckpt, "classifier")
    return _finish_chain(cfg, models, classifier)


def _finish_chain(cfg: dict, models, classifier) -> ChainInference:
    order = tuple(cfg.get("inference_effects_ordering", ())) or DEFAULT_ORDER
    return ChainInference(
        models,
        sample_rate=cfg["sample_rate"],
        effect_order=order,
        classifier=classifier,
        shuffle_effect_order=cfg.get("inference_effects_shuffle", False),
        use_all_effect_models=cfg.get("inference_use_all_effect_models", False),
        seed=int(cfg.get("seed", 0)),
    )
