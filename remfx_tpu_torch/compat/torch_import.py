"""The reference's torch checkpoints (``.ckpt``) into the port's modules.

Counterpart of the import half of ``remfx_tpu/compat/torch_import.py``
(``load_torch_state_dict``, ``strip_prefix``, ``detect_kind``,
``import_torch_checkpoint``); its ``export_*`` functions write torch
files from JAX trees and have no counterpart here.

Input: a Lightning checkpoint of the reference (the published Zenodo
files, scripts/download_ckpts.sh) or any file whose ``state_dict`` has
the same names: a removal model under ``model.model.`` (the ``RemFX``
module's ``model``, a backbone wrapper, whose ``model`` is the network),
the classifier under ``network.``. Output: ``(kind, state_dict)``, the
state dict keyed by the port module's own names, for
``load_state_dict(strict=True)``.

The port's modules already carry the reference's names (``from_jax.py``),
so for most families the import is the prefix strip and a few renames:

* ``demucs``: the upstream demucs spelling of the four layer lists
  (``encoder``, ``decoder``, ``tencoder``, ``tdecoder``) becomes
  torchaudio's (``freq_encoder`` ... ``time_decoder``);
* ``dcunet``: the ``bN`` and ``CbN`` norms keep their names; the norm of
  the file must be the model's (``detect_dcunet_norm_type``);
* ``umx``: the file holds the ``OpenUnmix`` network, which the port's
  ``UMXSeparator`` holds as ``model``;
* the ``num_batches_tracked`` counters of BatchNorm are read where the
  file has them (``train/checkpoint.py:load_torch_checkpoint`` starts
  them at 0 where it does not).

The JAX converters drop some keys without a word; the same keys are
dropped here, each logged by name: demucs' top-level keys outside its
layer lists and ``freq_emb``, and sub-keys of a layer outside its convs,
norms and ``dconv``; Cnn14's keys outside ``conv_block*``, ``fc1`` and
``heads.*`` (such as the torchaudio mel front end); DCUNet's keys
outside ``masker``'s layers (the STFT filterbanks, rebuilt by the
model); TCN's outside its blocks and ``output``; DPTNet's outside
asteroid's masker and filterbanks. One key is dropped where the JAX
package keeps it: Cnn14's ``bn0``, which the reference never applies and
which the JAX import carries into a ``bn0_unused`` entry that its own
structure check then refuses (ROADMAP.md §C). Everything else is for
``load_state_dict(strict=True)`` (``train/checkpoint.py:
load_torch_checkpoint``): a parameter or buffer of the module that the
file does not fill, or a key the module does not have, raises.

The file is read with ``torch.load(weights_only=True)``, and only its
``state_dict``: a file that needs a pickled class raises, naming the file
and the class (the JAX package unpickles everything).
"""

from __future__ import annotations

import pickle
import re

import torch

from remfx_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def load_torch_state_dict(path) -> dict:
    """A torch / Lightning checkpoint file -> ``{name: tensor}`` of its
    ``state_dict`` (the whole object when it has none)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        if found:
            raise ValueError(
                f"{path}: torch.load(weights_only=True) refuses the pickled class "
                f"{found.group(1)}; the port reads tensors only") from e
        raise ValueError(
            f"{path}: not a checkpoint that torch.load(weights_only=True) reads") from e
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: no state_dict in the checkpoint")
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def strip_prefix(sd: dict, prefixes=("model.model.", "model.", "network.")) -> dict:
    """Remove the longest matching Lightning wrapper prefix of each key."""
    out = {}
    for k, v in sd.items():
        for p in sorted(prefixes, key=len, reverse=True):
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def detect_kind(sd: dict) -> str:
    """The backbone family of a prefix-stripped state dict, from its keys
    (the JAX package's fingerprints, in its order)."""
    keys = set(sd)
    if any(k.startswith("masker.encoders") for k in keys):
        return "dcunet"
    # before demucs: asteroid DPTNet has "encoder.filterbank._filters",
    # which the demucs "encoder." prefix would claim
    if any(".mha.in_proj_weight" in k for k in keys):
        return "dptnet"
    if any(k.startswith(("freq_emb.", "tencoder.", "encoder.", "freq_encoder.",
                         "time_encoder.")) for k in keys):
        return "demucs"
    if any(k.startswith("conv_block1.") for k in keys):
        return "cnn14"
    if any(k.startswith("process_blocks.") for k in keys):
        return "tcn"
    if any(k.startswith(("lstm.weight_ih_l0", "fc1.weight", "bn1.")) for k in keys):
        return "umx"
    raise ValueError(
        "unrecognized checkpoint family; state-dict keys start with: "
        + ", ".join(sorted({k.split('.')[0] for k in keys})[:12]))


def detect_dcunet_norm_type(sd: dict) -> str:
    """'bN' or 'CbN' from a DCUNet state dict's norm parameters."""
    for k, v in sd.items():
        if ".norm.re_module.weight" in k:
            return "bN"
        if k.endswith(".norm.weight") and v.ndim == 2:
            return "CbN"
    return "bN"


def _keep(sd: dict, pattern: str) -> dict:
    """The keys that match ``pattern`` whole; the others are logged."""
    rx = re.compile(pattern)
    out = {}
    for k, v in sd.items():
        if rx.fullmatch(k):
            out[k] = v
        else:
            log.info("torch import skips %s", k)
    return out


def _tcn(sd):
    return _keep(sd, r"process_blocks\.\d+\.((conv1|res)\.(weight|bias)|relu\.weight)"
                     r"|output\.(weight|bias)")


def _cnn14(sd):
    return _keep(sd, r"conv_block\d\.(conv\d\.weight|bn\d\.(weight|bias|running_mean"
                     r"|running_var|num_batches_tracked))|fc1\.(weight|bias)"
                     r"|heads\.\d+\.(weight|bias)")


def _umx(sd):
    return {f"model.{k}": v for k, v in sd.items()}


_DEMUCS_LISTS = {
    "encoder": "freq_encoder", "decoder": "freq_decoder",
    "tencoder": "time_encoder", "tdecoder": "time_decoder",
    "freq_encoder": "freq_encoder", "freq_decoder": "freq_decoder",
    "time_encoder": "time_encoder", "time_decoder": "time_decoder",
}
_DEMUCS_PARTS = ("conv", "conv_tr", "norm1", "norm2", "rewrite", "dconv")


def _demucs(sd):
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "freq_emb":
            out[k] = v
        elif (parts[0] in _DEMUCS_LISTS and len(parts) > 2
              and parts[2] in _DEMUCS_PARTS):
            out[".".join([_DEMUCS_LISTS[parts[0]]] + parts[1:])] = v
        else:
            log.info("torch import skips %s", k)
    return out


def _dcunet(sd):
    kept = _keep(sd, r"masker\.(mask_bias|(encoders|decoders)\.\d+\.(conv|deconv|norm)\..+"
                     r"|output_layer\..+)")
    # the output layer with or without a conv wrapper, as the JAX import
    # reads it
    return {re.sub(r"^masker\.output_layer\.(conv|deconv)\.", "masker.output_layer.", k): v
            for k, v in kept.items()}


def _dptnet(sd):
    return _keep(sd, r"(encoder|decoder)\.filterbank\._filters|masker\.in_norm\.\w+"
                     r"|masker\.layers\.\d+\.\d+\.(mha|recurrent|linear|norm_mha|norm_ff)\..+"
                     r"|masker\.first_out\.[01]\.\w+|masker\.net_(out|gate)\.0\.\w+")


RENAMES = {"tcn": _tcn, "cnn14": _cnn14, "umx": _umx, "demucs": _demucs,
           "dcunet": _dcunet, "dptnet": _dptnet}


def import_torch_checkpoint(path):
    """A torch / Lightning ``.ckpt`` file -> ``(kind, state_dict)``, the
    state dict in the port module's names (of the network itself: a
    removal model's ``ModelWrapper.module``, or Cnn14)."""
    sd = strip_prefix(load_torch_state_dict(path))
    kind = detect_kind(sd)
    return kind, RENAMES[kind](sd)
