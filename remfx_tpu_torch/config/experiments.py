"""Experiment registry — all 27 reference experiment names plus model
configs (the cfg/exp/ + cfg/model/ surface, SURVEY.md §2.8).

The port's copy of ``remfx_tpu/config/experiments.py``, equal to it but
for ``accelerator``: the JAX package names the TPU, the port the card
("gpu"). Every removal experiment (tcn, demucs, dcunet, umx, dptnet;
``default`` is UMX), the Cnn14 classifiers and ``cls_panns_pt`` (the
frozen-embedding classifier on the in-repo Cnn14 trunk) build; the other
embedding classifiers need external HEAR checkpoints and raise
``RuntimeError`` when built. The chain experiments (``chain_inference*``,
``remfx_{oracle,detect,all}``) build through
``chain/build.py:build_chain``; their ``ckpts/*.ckpt`` paths are the
reference's published torch checkpoints, which ``compat/torch_import.py``
imports where the files are present; without them, vendored
``ckpts/<name>/`` directories take their place (``cli/demo_detect.py``)
or, for smoke runs, ``REMFX_ALLOW_RANDOM_CKPT=1`` gives random weights.

Model families: dcunet (chorus/delay/reverb removal), demucs
(distortion/compression removal), umx, dptnet, tcn, and the Cnn14
classifier variants. Chain-inference experiments define ``ckpts``,
``inference_effects_ordering``, and related keys exactly like
cfg/exp/remfx_{oracle,detect,all}.yaml.
"""

from __future__ import annotations

import copy

from remfx_tpu_torch.config.core import deep_update

CORE5 = ["distortion", "compressor", "reverb", "chorus", "delay"]

MODEL_CONFIGS = {
    "demucs": {
        "task": "removal", "name": "demucs",
        "lr": 1e-4, "lr_beta1": 0.95, "lr_beta2": 0.999, "lr_eps": 1e-6,
        "lr_weight_decay": 1e-3,
        "network": {"sources": ["mixture"], "audio_channels": 1, "nfft": 4096,
                     "channels": 48},
    },
    "dcunet": {
        "task": "removal", "name": "dcunet",
        "lr": 1e-4, "lr_beta1": 0.95, "lr_beta2": 0.999, "lr_eps": 1e-6,
        "lr_weight_decay": 1e-3,
        "network": {"architecture": "Large-DCUNet-20", "stft_kernel_size": 512,
                     "fix_length_mode": "pad", "num_bins": 1025},
    },
    "umx": {
        "task": "removal", "name": "umx",
        "lr": 1e-4, "lr_beta1": 0.95, "lr_beta2": 0.999, "lr_eps": 1e-6,
        "lr_weight_decay": 1e-3,
        "network": {"n_fft": 2048, "hop_length": 512, "n_channels": 1,
                     "alpha": 0.3},
    },
    "dptnet": {
        "task": "removal", "name": "dptnet",
        "lr": 1e-4, "lr_beta1": 0.95, "lr_beta2": 0.999, "lr_eps": 1e-6,
        "lr_weight_decay": 1e-3,
        "network": {"n_src": 1, "in_chan": 64, "out_chan": 64, "chunk_size": 100,
                     "n_repeats": 2, "fb_name": "free", "kernel_size": 16,
                     "n_filters": 64, "stride": 8, "num_bins": 1025},
    },
    "tcn": {
        "task": "removal", "name": "tcn",
        "lr": 1e-4, "lr_beta1": 0.95, "lr_beta2": 0.999, "lr_eps": 1e-6,
        "lr_weight_decay": 1e-3,
        "network": {"ninputs": 1, "noutputs": 1, "nblocks": 20,
                     "channel_growth": 0, "channel_width": 256,
                     "kernel_size": 7, "stack_size": 10, "dilation_growth": 2,
                     "causal": False, "num_bins": 1025},
    },
}


def _cls_panns(model_sr=48000, n_fft=2048, hop=512, n_mels=128,
               specaugment=False, mixup=False, label_smoothing=0.0):
    return {
        "task": "classifier", "name": "cnn14",
        "lr": 3e-4, "lr_weight_decay": 1e-3, "mixup": mixup,
        "label_smoothing": label_smoothing,
        "network": {"n_fft": n_fft, "hop_length": hop, "n_mels": n_mels,
                     "model_sample_rate": model_sr, "specaugment": specaugment},
    }


def _cls_embedding(kind: str):
    # frozen embedder + trainable MLP head; non-Cnn14 classifiers use the
    # CE-loss / multilabel-F1 path (reference quirk #9, models.py:457-488)
    return {
        "task": "classifier", "name": "embedding",
        "lr": 3e-4, "lr_weight_decay": 1e-3,
        "loss_type": "ce",
        "network": {"kind": kind},
    }


MODEL_CONFIGS.update({
    "cls_panns_16k": _cls_panns(model_sr=16000),
    "cls_panns_44k_label_smoothing": _cls_panns(model_sr=44100, label_smoothing=0.1),
    "cls_panns_48k": _cls_panns(),
    "cls_panns_48k_64": _cls_panns(n_mels=64),
    "cls_panns_48k_mixup": _cls_panns(mixup=True),
    "cls_panns_48k_specaugment": _cls_panns(specaugment=True),
    "cls_panns_48k_specaugment_label_smoothing": _cls_panns(
        specaugment=True, label_smoothing=0.1),
    # frozen-embedding classifiers (reference remfx/classifier.py:16-128):
    # `cls_panns_pt` is self-contained (the in-repo Cnn14 trunk @32 kHz IS
    # the PANNs embedder); the other three need external HEAR checkpoints
    # and fail loudly at build time (models/embedding_classifiers.py)
    # instead of silently aliasing a different network.
    "cls_panns_pt": _cls_embedding("panns"),
    "cls_vggish": _cls_embedding("vggish"),
    "cls_wav2clip": _cls_embedding("wav2clip"),
    "cls_wav2vec2": _cls_embedding("wav2vec2"),
})


def _base(model: str | None, **overrides):
    cfg = {
        "accelerator": "gpu",
        "num_kept_effects": [0, 0],
        "num_removed_effects": [1, 1],
        "shuffle_kept_effects": True,
        "shuffle_removed_effects": False,
        "num_classes": 5,
        "effects_to_keep": [],
        "effects_to_remove": [],
        "datamodule": {"train_batch_size": 16, "test_batch_size": 1},
    }
    if model is not None:
        # deep copy: dotted CLI overrides must not mutate the global
        # model registry through the shared nested "network" dict
        cfg["model"] = copy.deepcopy(MODEL_CONFIGS[model])
    deep_update(cfg, overrides)
    return cfg


def _effect_specific(effect: str, model: str):
    return _base(
        model,
        num_classes=1,
        effects_to_remove=[effect],
    )


# exact per-file effects_to_keep orders from reference cfg/exp/*_aug.yaml
# (immaterial behaviorally — shuffle_kept_effects is True — but kept
# verbatim for config parity)
_AUG_KEEP_ORDER = {
    "chorus": ["compressor", "distortion", "delay", "reverb"],
    "delay": ["compressor", "distortion", "chorus", "reverb"],
    "reverb": ["compressor", "distortion", "chorus", "delay"],
    "distortion": ["compressor", "reverb", "chorus", "delay"],
    "compressor": ["distortion", "chorus", "delay", "reverb"],
}


def _effect_aug(effect: str, model: str):
    others = _AUG_KEEP_ORDER[effect]
    return _base(
        model,
        num_kept_effects=[0, 4],
        num_removed_effects=[1, 1],
        num_classes=5,  # reference cfg/exp/*_aug.yaml (5, unlike non-aug)
        effects_to_keep=others,
        effects_to_remove=[effect],
    )


def _monolithic(n_min: int, n_max: int, model="demucs", shuffle=True,
                remove_order=None):
    return _base(
        model,
        num_removed_effects=[n_min, n_max],
        shuffle_removed_effects=shuffle,
        effects_to_remove=list(remove_order or CORE5),
    )


def _classifier(model="cls_panns_48k_specaugment", dynamic=False):
    cfg = _base(
        model,
        num_removed_effects=[0, 5],
        shuffle_removed_effects=True,
        effects_to_remove=list(CORE5),
        log_audio=False,
        datamodule={"train_batch_size": 64, "test_batch_size": 256},
        # epoch-bounded like the reference (max_steps: -1 = unlimited,
        # cfg/exp/5-5_full_cls.yaml trainer block)
        trainer={"max_epochs": 300, "max_steps": -1},
        callbacks={"model_checkpoint": {"monitor": "valid_avg_acc",
                                        "mode": "max"}},
    )
    if dynamic:
        deep_update(cfg, {"datamodule": {"dataset_type": "dynamic",
                                          "train_batch_size": 32,
                                          "num_workers": 12,
                                          "parallel": True}})
    return cfg


def _chain(classifier=False, use_all=False, custom=False, model="demucs",
           aug=True, shuffle=False):
    cfg = _base(
        model,
        num_removed_effects=[0, 5],
        shuffle_removed_effects=True,
        effects_to_remove=list(CORE5),
        render_files=False,
    )
    cfg["dcunet"] = copy.deepcopy(MODEL_CONFIGS["dcunet"])
    # chain_inference uses the non-FXAug checkpoints (reference
    # cfg/exp/chain_inference.yaml:48-60); every other chain experiment
    # uses the *_aug ones
    sfx = "_aug" if aug else ""
    cfg["ckpts"] = {
        "RandomPedalboardDistortion": {
            "model": "demucs",
            "ckpt_path": f"ckpts/demucs_distortion{sfx}.ckpt"},
        "RandomPedalboardCompressor": {
            "model": "demucs",
            "ckpt_path": f"ckpts/demucs_compressor{sfx}.ckpt"},
        "RandomPedalboardReverb": {
            "model": "dcunet",
            "ckpt_path": f"ckpts/dcunet_reverb{sfx}.ckpt"},
        "RandomPedalboardChorus": {
            "model": "dcunet",
            "ckpt_path": f"ckpts/dcunet_chorus{sfx}.ckpt"},
        "RandomPedalboardDelay": {
            "model": "dcunet",
            "ckpt_path": f"ckpts/dcunet_delay{sfx}.ckpt"},
    }
    cfg["inference_effects_ordering"] = [
        "RandomPedalboardDistortion",
        "RandomPedalboardCompressor",
        "RandomPedalboardReverb",
        "RandomPedalboardChorus",
        "RandomPedalboardDelay",
    ]
    cfg["num_bins"] = 1025
    # chain_inference*: False; remfx_{oracle,detect,all}: True
    # (reference cfg/exp/*.yaml inference_effects_shuffle lines)
    cfg["inference_effects_shuffle"] = shuffle
    cfg["inference_use_all_effect_models"] = use_all
    if classifier:
        cfg["classifier"] = _cls_panns(specaugment=True)
        cfg["classifier_ckpt"] = "ckpts/classifier.ckpt"
    if custom:
        cfg["datamodule"] = {"dataset_type": "inference",
                             "train_batch_size": 1, "test_batch_size": 1}
    return cfg


EXPERIMENTS = {
    # effect-specific
    "chorus": lambda: _effect_specific("chorus", "dcunet"),
    "delay": lambda: _effect_specific("delay", "dcunet"),
    "reverb": lambda: _effect_specific("reverb", "dcunet"),
    "distortion": lambda: _effect_specific("distortion", "demucs"),
    "compression": lambda: _effect_specific("compressor", "demucs"),
    # FXAug variants
    "chorus_aug": lambda: _effect_aug("chorus", "dcunet"),
    "delay_aug": lambda: _effect_aug("delay", "dcunet"),
    "reverb_aug": lambda: _effect_aug("reverb", "dcunet"),
    "distortion_aug": lambda: _effect_aug("distortion", "demucs"),
    "compression_aug": lambda: _effect_aug("compressor", "demucs"),
    # monolithic N-N
    "0-0": lambda: _monolithic(0, 0),
    "1-1": lambda: _monolithic(1, 1),
    "2-2": lambda: _monolithic(2, 2),
    "3-3": lambda: _monolithic(3, 3),
    "4-4": lambda: _monolithic(4, 4),
    "5-5": lambda: _monolithic(5, 5),
    "5-1": lambda: _monolithic(1, 1),
    "5-5_full": lambda: _monolithic(0, 5),
    # reference cfg/exp/default.yaml: shuffle False + its own list order
    # (order matters without shuffle: effects apply in list order)
    "default": lambda: _monolithic(
        0, 5, model="umx", shuffle=False,
        remove_order=["compressor", "reverb", "chorus", "delay",
                      "distortion"]),
    # classifier
    "5-5_full_cls": lambda: _classifier(),
    "5-5_full_cls_dynamic": lambda: _classifier(dynamic=True),
    # chain inference
    "chain_inference": lambda: _chain(aug=False),
    "chain_inference_aug": lambda: _chain(),
    "chain_inference_aug_classifier": lambda: _chain(classifier=True),
    "chain_inference_custom": lambda: _chain(custom=True),
    "remfx_oracle": lambda: _chain(shuffle=True),
    "remfx_detect": lambda: _chain(classifier=True, shuffle=True),
    "remfx_all": lambda: _chain(classifier=True, use_all=True,
                                shuffle=True),
}


def apply_experiment(cfg: dict, name: str) -> dict:
    if name not in EXPERIMENTS:
        raise SystemExit(
            f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}"
        )
    return deep_update(cfg, EXPERIMENTS[name]())
