"""Weights carried from the JAX package to the port.

Input: a JAX variables tree (nested dicts of arrays; numpy arrays, or
anything ``np.asarray`` takes) as ``remfx_tpu`` builds or loads it.
Output: a ``state_dict`` of torch tensors for the port's module, to be
loaded with ``load_state_dict(strict=True)``.

* ``cnn14_state_dict`` is the inverse of
  ``remfx_tpu/compat/torch_import.py:convert_cnn14``.
* ``demucs_state_dict`` is a copy of ``torch_import.py:export_demucs``
  (torchaudio naming), ending in torch tensors.
* ``tcn_state_dict`` is the inverse of ``torch_import.py:convert_tcn``
  (the reference's ``process_blocks.{n}`` names).
* ``dcunet_state_dict`` is a copy of ``torch_import.py:export_dcunet``
  (asteroid naming, ``masker.mask_bias`` included), ending in torch
  tensors, for both the ``bN`` and ``CbN`` norms.
* ``umx_state_dict``: the JAX UMX keeps torch's names and layouts
  (``remfx_tpu/models/umx.py``), so this is a re-rooting, with the
  BatchNorm statistics taken from ``batch_stats``.
* ``dptnet_state_dict`` is a copy of ``torch_import.py:export_dptnet``
  (asteroid naming), ending in torch tensors.
* ``embedding_classifier_state_dicts``: the ``EmbeddingClassifier``'s head
  (``proj.fc{0,1,2}``) and, for PANNs, the frozen Cnn14 trunk that its
  ``embed_fn`` closes over, through ``cnn14_state_dict``.

Layouts: flax conv ``(kh, kw, in, out)`` / ``(k, in, out)`` -> torch
``(out, in, kh, kw)`` / ``(out, in, k)``; Dense ``(in, out)`` -> Linear
``(out, in)``; BatchNorm ``params {scale, bias}`` + ``batch_stats {mean,
var}`` -> ``weight``, ``bias``, ``running_mean``, ``running_var``.
Every leaf of the JAX tree must be used: a leaf left over raises.

No code here reads ``ckpts/``: ``compat/ocdbt.py`` reads the vendored
orbax directories without JAX, and ``train/checkpoint.py``'s loaders
pass their trees here.
"""

from __future__ import annotations

import numpy as np
import torch


class _Leaves:
    """Reads leaves of a nested-dict tree by path and remembers which were
    read, so that ``check_all_used`` can reject a leaf left over."""

    def __init__(self, tree: dict):
        self.tree = tree
        self.used: set[tuple] = set()

    def get(self, *path) -> np.ndarray:
        node = self.tree
        for p in path:
            node = node[p]
        self.used.add(tuple(path))
        return np.asarray(node, dtype=np.float32)

    def subtree(self, *path) -> dict:
        node = self.tree
        for p in path:
            node = node[p]
        return node

    def check_all_used(self):
        left = []

        def walk(node, path):
            if isinstance(node, dict) or hasattr(node, "items"):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif path not in self.used:
                left.append("/".join(map(str, path)))

        walk(self.tree, ())
        if left:
            raise ValueError(f"JAX leaves not carried over: {sorted(left)[:10]}")


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def cnn14_state_dict(variables: dict) -> dict:
    """Cnn14 ``{'params', 'batch_stats'}`` -> port ``Cnn14`` state dict."""
    leaves = _Leaves(variables)
    sd: dict = {}
    for blk in range(1, 7):
        name = f"conv_block{blk}"
        for conv in ("conv1", "conv2"):
            k = leaves.get("params", name, conv, "kernel")  # (kh, kw, in, out)
            sd[f"{name}.{conv}.weight"] = k.transpose(3, 2, 0, 1)
        for bn in ("bn1", "bn2"):
            sd[f"{name}.{bn}.weight"] = leaves.get("params", name, bn, "scale")
            sd[f"{name}.{bn}.bias"] = leaves.get("params", name, bn, "bias")
            sd[f"{name}.{bn}.running_mean"] = leaves.get(
                "batch_stats", name, bn, "mean")
            sd[f"{name}.{bn}.running_var"] = leaves.get(
                "batch_stats", name, bn, "var")
    sd["fc1.weight"] = leaves.get("params", "fc1", "kernel").T
    sd["fc1.bias"] = leaves.get("params", "fc1", "bias")
    heads = sorted(k for k in leaves.subtree("params") if k.startswith("head"))
    for i in range(len(heads)):
        sd[f"heads.{i}.weight"] = leaves.get("params", f"head{i}", "kernel").T
        sd[f"heads.{i}.bias"] = leaves.get("params", f"head{i}", "bias")
    leaves.check_all_used()
    out = _tensors(sd)
    for blk in range(1, 7):
        for bn in ("bn1", "bn2"):
            # a buffer PyTorch keeps for training; the JAX tree has none
            out[f"conv_block{blk}.{bn}.num_batches_tracked"] = torch.tensor(0)
    return out


def _conv_w(k: np.ndarray) -> np.ndarray:
    if k.ndim == 3:  # (k, in, out) -> (out, in, k)
        return k.transpose(2, 1, 0)
    return k.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)


def _emit_dconv(sd: dict, leaves: _Leaves, path: tuple, prefix: str):
    tree = leaves.subtree(*path)
    for d in sorted({int(n.split("_")[0][6:]) for n in tree}):
        has_lstm = f"layers{d}_lstm" in tree
        has_attn = f"layers{d}_attn" in tree
        idx_conv2 = 3 + has_lstm + has_attn
        get = lambda *p: leaves.get(*path, *p)  # noqa: E731
        sd[f"{prefix}.{d}.0.weight"] = _conv_w(get(f"layers{d}_conv1", "kernel"))
        sd[f"{prefix}.{d}.0.bias"] = get(f"layers{d}_conv1", "bias")
        sd[f"{prefix}.{d}.1.weight"] = get(f"layers{d}_norm1", "scale")
        sd[f"{prefix}.{d}.1.bias"] = get(f"layers{d}_norm1", "bias")
        if has_lstm:
            for k in tree[f"layers{d}_lstm"]["lstm"]:
                sd[f"{prefix}.{d}.3.lstm.{k}"] = get(f"layers{d}_lstm", "lstm", k)
            sd[f"{prefix}.{d}.3.linear.weight"] = get(
                f"layers{d}_lstm", "linear", "kernel").T
            sd[f"{prefix}.{d}.3.linear.bias"] = get(
                f"layers{d}_lstm", "linear", "bias")
        if has_attn:
            j = 3 + has_lstm
            for name in tree[f"layers{d}_attn"]:
                sd[f"{prefix}.{d}.{j}.{name}.weight"] = get(
                    f"layers{d}_attn", name, "kernel").T[..., None]
                sd[f"{prefix}.{d}.{j}.{name}.bias"] = get(
                    f"layers{d}_attn", name, "bias")
        sd[f"{prefix}.{d}.{idx_conv2}.weight"] = _conv_w(
            get(f"layers{d}_conv2", "kernel"))
        sd[f"{prefix}.{d}.{idx_conv2}.bias"] = get(f"layers{d}_conv2", "bias")
        sd[f"{prefix}.{d}.{idx_conv2 + 1}.weight"] = get(f"layers{d}_norm2", "scale")
        sd[f"{prefix}.{d}.{idx_conv2 + 1}.bias"] = get(f"layers{d}_norm2", "bias")
        sd[f"{prefix}.{d}.{idx_conv2 + 3}.scale"] = get(f"layers{d}_scale")


_DEMUCS_LISTS = ("freq_encoder", "freq_decoder", "time_encoder", "time_decoder")


def demucs_state_dict(variables: dict) -> dict:
    """HDemucs ``{'params'}`` -> port ``HDemucs`` state dict (torchaudio
    names; the module, not its wrapper)."""
    leaves = _Leaves(variables)
    params = leaves.subtree("params")
    sd: dict = {}
    for lname, tree in params.items():
        if lname == "freq_emb":
            sd["freq_emb.embedding.weight"] = leaves.get("params", lname, "weight")
            continue
        base, _, idx = lname.rpartition("_")
        if base not in _DEMUCS_LISTS:
            continue  # reported by check_all_used
        tname = f"{base}.{idx}"
        for sub in ("conv", "rewrite"):
            if sub in tree:
                sd[f"{tname}.{sub}.weight"] = _conv_w(
                    leaves.get("params", lname, sub, "kernel"))
                sd[f"{tname}.{sub}.bias"] = leaves.get("params", lname, sub, "bias")
        for sub in ("norm1", "norm2"):
            if sub in tree:
                sd[f"{tname}.{sub}.weight"] = leaves.get("params", lname, sub, "scale")
                sd[f"{tname}.{sub}.bias"] = leaves.get("params", lname, sub, "bias")
        if "conv_tr_kernel" in tree:
            # (k, in, out) in torch's tap order -> (in, out, k)
            k = leaves.get("params", lname, "conv_tr_kernel").transpose(1, 2, 0)
            # a freq decoder is 2d (weight (in, out, k, 1)) iff its rewrite
            # is the 3x3 2d conv; the time-axis freq layer and every time
            # decoder (including the rewrite-less empty one) are 1d
            if base == "freq_decoder" and "rewrite" in tree and np.ndim(
                    tree["rewrite"]["kernel"]) == 4:
                k = k[..., None]
            sd[f"{tname}.conv_tr.weight"] = k
            sd[f"{tname}.conv_tr.bias"] = leaves.get("params", lname, "conv_tr_bias")
        if "dconv" in tree:
            _emit_dconv(sd, leaves, ("params", lname, "dconv"),
                        f"{tname}.dconv.layers")
    leaves.check_all_used()
    return _tensors(sd)


def tcn_state_dict(variables: dict) -> dict:
    """TCN ``{'params'}`` -> port ``TCN`` state dict (the module, not its
    wrapper)."""
    leaves = _Leaves(variables)
    sd: dict = {}
    blocks = sorted(int(k[5:]) for k in leaves.subtree("params")
                    if k.startswith("block"))
    for n in blocks:
        get = lambda *p: leaves.get("params", f"block{n}", *p)  # noqa: E731
        sd[f"process_blocks.{n}.conv1.weight"] = _conv_w(get("conv1", "kernel"))
        sd[f"process_blocks.{n}.conv1.bias"] = get("conv1", "bias")
        sd[f"process_blocks.{n}.relu.weight"] = get("relu", "weight")
        sd[f"process_blocks.{n}.res.weight"] = _conv_w(get("res", "kernel"))
    sd["output.weight"] = _conv_w(leaves.get("params", "output", "kernel"))
    sd["output.bias"] = leaves.get("params", "output", "bias")
    leaves.check_all_used()
    return _tensors(sd)


def _dcunet_conv(sd: dict, leaves: _Leaves, lname: str, tname: str,
                 transpose: bool):
    tree = leaves.subtree("params", lname)
    for part in ("re", "im"):
        k = leaves.get("params", lname, f"{part}_kernel")  # (kh, kw, in, out)
        # ConvTranspose2d (in, out, kh, kw) in tap order; Conv2d (out, in, kh, kw)
        sd[f"{tname}.{part}_module.weight"] = (
            k.transpose(2, 3, 0, 1) if transpose else k.transpose(3, 2, 0, 1))
        if f"{part}_bias" in tree:
            sd[f"{tname}.{part}_module.bias"] = leaves.get(
                "params", lname, f"{part}_bias")


def dcunet_state_dict(variables: dict) -> dict:
    """DCUNet ``{'params', 'batch_stats'}`` -> port ``DCUNet`` state dict
    (asteroid names; the module, not its wrapper). Each BatchNorm gains
    the ``num_batches_tracked`` buffer that PyTorch keeps for training."""
    leaves = _Leaves(variables)
    sd: dict = {}
    counters = []
    for lname, tree in leaves.subtree("params").items():
        if lname == "mask_bias":
            sd["masker.mask_bias"] = leaves.get("params", lname)
            continue
        if lname == "output_conv":
            _dcunet_conv(sd, leaves, lname, "masker.output_layer", True)
            continue
        kind, idx = lname[:3], lname[3:].split("_")[0]
        if kind not in ("enc", "dec"):
            continue  # reported by check_all_used
        base = "masker.encoders" if kind == "enc" else "masker.decoders"
        if lname.endswith("_conv"):
            attr = "conv" if kind == "enc" else "deconv"
            _dcunet_conv(sd, leaves, lname, f"{base}.{idx}.{attr}", kind == "dec")
        elif lname.endswith("_norm"):
            norm = f"{base}.{idx}.norm"
            if "weight" in tree:  # CbN
                sd[f"{norm}.weight"] = leaves.get("params", lname, "weight")
                sd[f"{norm}.bias"] = leaves.get("params", lname, "bias")
                for stat in ("running_mean", "running_covar"):
                    sd[f"{norm}.{stat}"] = leaves.get("batch_stats", lname, stat)
                counters.append(norm)
            else:
                for part in ("re", "im"):
                    sub = f"{norm}.{part}_module"
                    p = ("params", lname, f"{part}_module")
                    s = ("batch_stats", lname, f"{part}_module")
                    sd[f"{sub}.weight"] = leaves.get(*p, "scale")
                    sd[f"{sub}.bias"] = leaves.get(*p, "bias")
                    sd[f"{sub}.running_mean"] = leaves.get(*s, "mean")
                    sd[f"{sub}.running_var"] = leaves.get(*s, "var")
                    counters.append(sub)
    leaves.check_all_used()
    out = _tensors(sd)
    for name in counters:
        out[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return out


def umx_state_dict(variables: dict) -> dict:
    """UMXSeparator ``{'params', 'batch_stats'}`` -> port ``UMXSeparator``
    state dict (the module, not its wrapper)."""
    leaves = _Leaves(variables)
    sd: dict = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + (k,))
            else:
                sd[".".join(path[1:] + (k,))] = leaves.get(*path, k)

    walk(leaves.subtree("params"), ("params",))
    walk(leaves.subtree("batch_stats"), ("batch_stats",))
    leaves.check_all_used()
    out = _tensors(sd)
    for bn in ("bn1", "bn2", "bn3"):
        out[f"model.{bn}.num_batches_tracked"] = torch.tensor(0)
    return out


_DPT_SIMPLE = {
    "encoder_filters": "encoder.filterbank._filters",
    "decoder_filters": "decoder.filterbank._filters",
    "first_out_prelu": "masker.first_out.0.weight",
    "first_out_weight": "masker.first_out.1.weight",
    "first_out_bias": "masker.first_out.1.bias",
    "net_out_weight": "masker.net_out.0.weight",
    "net_out_bias": "masker.net_out.0.bias",
    "net_gate_weight": "masker.net_gate.0.weight",
    "net_gate_bias": "masker.net_gate.0.bias",
}


def dptnet_state_dict(variables: dict) -> dict:
    """DPTNet ``{'params'}`` -> port ``DPTNet`` state dict (asteroid names;
    the module, not its wrapper)."""
    leaves = _Leaves(variables)
    sd: dict = {}
    for name, tree in leaves.subtree("params").items():
        if name in _DPT_SIMPLE:
            sd[_DPT_SIMPLE[name]] = leaves.get("params", name)
        elif name == "in_norm":
            for p in tree:
                sd[f"masker.in_norm.{p}"] = leaves.get("params", name, p)
        elif name.startswith("layers_"):
            _, r, which = name.split("_")
            base = f"masker.layers.{r}.{0 if which == 'intra' else 1}"
            for sub, leaf in tree.items():
                if sub == "mha":
                    for p in leaf:
                        tname = (f"out_proj.{p[9:]}" if p.startswith("out_proj_")
                                 else p)
                        sd[f"{base}.mha.{tname}"] = leaves.get("params", name, sub, p)
                elif sub in ("recurrent", "norm_mha", "norm_ff"):
                    for p in leaf:
                        sd[f"{base}.{sub}.{p}"] = leaves.get("params", name, sub, p)
                elif sub in ("linear_weight", "linear_bias"):
                    sd[f"{base}.linear.{sub[7:]}"] = leaves.get("params", name, sub)
    leaves.check_all_used()
    return _tensors(sd)


def embedding_classifier_state_dicts(variables: dict, trunk_variables=None):
    """``EmbeddingClassifier`` ``{'params': {'proj': ...}}`` and, optionally,
    the PANNs trunk's Cnn14 variables -> ``(head, trunk)`` state dicts: the
    head for the port's ``EmbeddingClassifier.load_state_dict``, the trunk
    (``None`` without trunk variables) for ``make_panns_embed_fn``."""
    leaves = _Leaves(variables)
    sd: dict = {}
    for i in range(3):
        sd[f"proj.fc{i}.weight"] = leaves.get("params", "proj", f"fc{i}", "kernel").T
        sd[f"proj.fc{i}.bias"] = leaves.get("params", "proj", f"fc{i}", "bias")
    leaves.check_all_used()
    trunk = None if trunk_variables is None else cnn14_state_dict(trunk_variables)
    return _tensors(sd), trunk
