"""The port's config tree and its Hydra-like CLI.

Counterpart of ``remfx_tpu/config/core.py``: ``default_config`` (the
mirror of the reference's cfg/config.yaml), ``default_effect_overrides``
(cfg/effects/all.yaml), ``+exp=NAME`` experiment composition, dotted
overrides (``datamodule.train_batch_size=8``) and ``model=NAME`` group
swaps. Copied, not imported, so that the port loads nothing of the JAX
package; ``tests/test_torch_render.py`` and ``tests/test_torch_train.py``
hold the copies equal to the JAX ones. ``accelerator`` picks the device
(``train/loop.py:device_of``): ``"cpu"`` runs on the host, as the tests
do; anything else is the card.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any


def default_config() -> dict:
    """Mirror of cfg/config.yaml (reference, lines 1-120)."""
    return {
        "seed": 12345,
        "train": True,
        "sample_rate": 48000,
        "chunk_size": 262144,
        "logs_dir": "./logs",
        "render_files": True,
        "render_root": "./data",
        "accelerator": None,
        "log_audio": True,
        "num_kept_effects": [2, 2],
        "num_removed_effects": [2, 2],
        "shuffle_kept_effects": True,
        "shuffle_removed_effects": False,
        "num_classes": 5,
        "effects_to_keep": ["reverb", "chorus", "delay"],
        "effects_to_remove": ["compressor", "distortion"],
        "effects": default_effect_overrides(),
        "dataset_root": os.environ.get("DATASET_ROOT"),
        "datamodule": {
            "dataset_type": "offline",  # offline | dynamic | inference
            "synthetic": False,
            "train_chunks": 8000,
            "val_chunks": 1000,
            "test_chunks": 1000,
            "train_batch_size": 16,
            "test_batch_size": 1,
            "render_batch_size": 8,
            "num_workers": 8,
        },
        "model": None,
        "trainer": {
            "max_steps": 50000,
            "max_epochs": -1,
            "log_every_n_steps": 1,
            "gradient_clip_val": 10.0,
            "accumulate_grad_batches": 1,
            # 32 (reference cfg/config.yaml:111) or "bf16-mixed": bf16
            # compute with fp32 master weights and optimizer
            "precision": 32,
            "devices": 1,
            # resume from the newest "last" ckpt in logs_dir (preemption
            # recovery; upgrade over reference cfg/config.yaml:36 which
            # only saves last and requires a manual ckpt_path)
            "auto_resume": False,
        },
        "callbacks": {
            "model_checkpoint": {"monitor": "valid_loss", "mode": "min",
                                 "save_top_k": 1, "save_last": True},
        },
        "logger": "csv",
        "ckpt_path": None,
        # params-only donor checkpoint for fine-tuning (fresh optimizer/
        # LR schedule); this framework's addition, no reference analogue
        "warm_start": None,
    }


def default_effect_overrides() -> dict:
    """cfg/effects/all.yaml — narrowed dataset-generation ranges."""
    return {
        "chorus": {
            "min_rate_hz": 0.25, "max_rate_hz": 1.5,
            "min_feedback": 0.1, "max_feedback": 0.4,
            "min_depth": 0.2, "max_depth": 0.6,
            "min_mix": 0.15, "max_mix": 0.4,
        },
        "distortion": {"min_drive_db": 8.0, "max_drive_db": 25.0},
        "compressor": {
            "min_threshold_db": -42.0, "max_threshold_db": -20.0,
            "min_ratio": 1.5, "max_ratio": 6.0,
        },
        "reverb": {
            "min_room_size": 0.3, "max_room_size": 1.0,
            "min_damping": 0.2, "max_damping": 1.0,
            "min_wet_dry": 0.2, "max_wet_dry": 0.6,
            "min_width": 0.2, "max_width": 1.0,
        },
        "delay": {
            "min_delay_seconds": 0.1, "max_delay_sconds": 1.0,
            "min_feedback": 0.05, "max_feedback": 0.3,
            "min_mix": 0.1, "max_mix": 0.35,
        },
    }


def _parse_value(s: str) -> Any:
    low = s.strip()
    if low in ("null", "None", "~"):
        return None
    if low in ("true", "True"):
        return True
    if low in ("false", "False"):
        return False
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        pass
    # Hydra-style bracket list with bare words: [distortion,compressor],
    # possibly nested: [[distortion],[chorus,delay]] — split only at
    # top-level commas so nested lists recurse intact
    if low.startswith("[") and low.endswith("]"):
        inner = low[1:-1].strip()
        if not inner:
            return []
        items, depth, start = [], 0, 0
        for i, ch in enumerate(inner):
            if ch in "[(":
                depth += 1
            elif ch in "])":
                depth -= 1
            elif ch == "," and depth == 0:
                items.append(inner[start:i])
                start = i + 1
        items.append(inner[start:])
        return [_parse_value(item) for item in items]
    return low


def set_by_path(cfg: dict, path: str, value: Any):
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def deep_update(base: dict, upd: dict) -> dict:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def parse_cli(argv: list[str]) -> dict:
    """Parse Hydra-style args: ``+exp=NAME``, ``a.b=c``, ``+a.b=c``."""
    cfg = default_config()
    exp_name = None
    overrides = []
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"cannot parse argument {arg!r}; expected key=value")
        k, v = arg.split("=", 1)
        k = k.lstrip("+")
        if k == "exp":
            exp_name = v
        else:
            overrides.append((k, _parse_value(v)))
    if exp_name is not None:
        from remfx_tpu_torch.config.experiments import apply_experiment

        cfg = apply_experiment(cfg, exp_name)
    for k, v in overrides:
        if k == "model" and isinstance(v, str):
            # Hydra group override `model=NAME`: swap in the named model
            # config (cfg/model/NAME.yaml equivalent)
            from remfx_tpu_torch.config.experiments import MODEL_CONFIGS

            if v not in MODEL_CONFIGS:
                raise SystemExit(
                    f"unknown model config {v!r}; "
                    f"known: {sorted(MODEL_CONFIGS)}"
                )
            set_by_path(cfg, k, copy.deepcopy(MODEL_CONFIGS[v]))
            continue
        set_by_path(cfg, k, v)
    return cfg


def clone(cfg: dict) -> dict:
    return copy.deepcopy(cfg)
