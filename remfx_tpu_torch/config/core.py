"""The port's copy of the JAX package's render defaults.

Counterpart of ``remfx_tpu/config/core.py``: the top level and the
``datamodule`` of ``default_config`` (the mirror of the reference's
cfg/config.yaml) and ``default_effect_overrides`` (cfg/effects/all.yaml),
which the data-synthesis path reads. Copied, not imported, so that the
port loads nothing of the JAX package; ``tests/test_torch_render.py``
holds the copies equal to the JAX dicts. The rest of that config (model,
trainer, callbacks) and the CLI surface are not ported yet.
"""

from __future__ import annotations

import os


def default_config() -> dict:
    """Mirror of cfg/config.yaml (reference, lines 1-120): the top level
    and the datamodule."""
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
