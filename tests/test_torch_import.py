"""The port's torch-checkpoint import (``remfx_tpu_torch/compat/
torch_import.py``) against the JAX package's on the CPU.

For every family a ``.ckpt`` in the reference's Lightning layout
(``{"state_dict": {"model.model." + k: v}}`` for a remover,
``"network." + k`` for the classifier): from a seeded port model's
``state_dict()`` (TCN, Cnn14, UMX, Mini-DCUNet-6 with each norm, DPTNet),
from ``export_demucs`` of a small seeded JAX HDemucs in both naming
styles, and from ``export_dcunet`` of the vendored trained
``dcunet_reverb_aug_r4``. Each file goes through both packages'
``import_torch_checkpoint``; the two ``sample()`` outputs agree to 1e-5 of
the JAX output's peak (Cnn14: the probabilities to 1e-5), and the port
model loaded from a file of its own weights equals the model it was
written from bit for bit.

Where the JAX import is at fault, the test says so and the port does not
copy it (ROADMAP.md §C): the JAX UMX tree is rooted at the OpenUnmix
network, not at the separator its chain builds, so its structure check
refuses every UMX file; and it carries Cnn14's unused ``bn0`` into a
``bn0_unused`` entry that the same check refuses. The port loads both.

``build_chain`` with ``.ckpt`` slots and a ``.ckpt`` classifier (a
remfx_detect-shaped config at small widths, HDemucs residual through
``identity_init``) gives JAX's labels, and its test_step metrics to 1e-4
relative, the chain tolerance of tests/test_torch_chain.py.
"""

import copy
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.build import build_chain as jax_build_chain
from remfx_tpu.compat import torch_import as jti
from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.train.checkpoint import load_trained_wrapper as jax_load_trained
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.compat import torch_import as tti
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.train.checkpoint import load_torch_checkpoint

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
T = 8192
TOL = 1e-5
TCN = dict(nblocks=3, channel_width=8, kernel_size=3, dilation_growth=2)
UMX = dict(n_fft=512, hop_length=256, hidden_size=64)
DEMUCS = dict(channels=8, nfft=64, depth=3)
DCUNET = dict(architecture="Mini-DCUNet-6", stft_kernel_size=64)
DPTNET = dict(chunk_size=20, n_repeats=1)


def _audio(seed=0, rows=2, length=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 1, length)) * np.linspace(0.2, 1.0, length)
    return (0.3 * x).astype(np.float32)


def _seeded(seed, build):
    torch.manual_seed(seed)
    model = build()
    with torch.no_grad():  # running statistics away from (0, 1)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.2, 0.2)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif name.endswith("running_covar"):  # (Vrr, Vri, Vii) stays positive
                buf.mul_(1.3)
    return model


def _write(path, sd, prefix="model.model."):
    torch.save({"state_dict": {prefix + k: torch.as_tensor(np.array(v))
                               for k, v in sd.items()},
                "epoch": 3, "global_step": 1200}, path)
    return path


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# each case: (expected kind, the port model to load into, the JAX model,
# the port model the file was written from, or None)
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    out = {}
    w = _seeded(0, lambda: make_model("tcn", device="cpu", **TCN))
    out["tcn"] = (_write(d / "tcn.ckpt", w.module.state_dict()), "tcn",
                  lambda: make_model("tcn", device="cpu", **TCN),
                  jax_make_model("tcn", **TCN), w)
    w = _seeded(1, lambda: make_model("umx", device="cpu", **UMX))
    out["umx"] = (_write(d / "umx.ckpt", w.module.model.state_dict()), "umx",
                  lambda: make_model("umx", device="cpu", **UMX),
                  jax_make_model("umx", **UMX), w)
    for style in ("torchaudio", "upstream"):
        jw = jax_make_model("demucs", **DEMUCS)
        v = _np(jw.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 4096))))
        out[f"demucs_{style}"] = (
            _write(d / f"demucs_{style}.ckpt", jti.export_demucs(v, style)), "demucs",
            lambda: make_model("demucs", device="cpu", **DEMUCS), jw, None)
    for i, norm in enumerate(("bN", "CbN")):
        w = _seeded(3 + i, lambda: make_model("dcunet", norm_type=norm, device="cpu",
                                              **DCUNET))
        out[f"dcunet_{norm}"] = (
            _write(d / f"dcunet_{norm}.ckpt", w.module.state_dict()), "dcunet",
            lambda norm=norm: make_model("dcunet", norm_type=norm, device="cpu", **DCUNET),
            jax_make_model("dcunet", norm_type=norm, **DCUNET), w)
    _, jw, v = jax_load_trained(str(ROOT / "ckpts" / "dcunet_reverb_aug_r4"))
    net = dict(architecture="Large-DCUNet-20", stft_kernel_size=512,
               fix_length_mode="pad", identity_init=True)
    out["dcunet_trained"] = (
        _write(d / "dcunet_trained.ckpt", jti.export_dcunet(_np(v))), "dcunet",
        lambda: make_model("dcunet", device="cpu", **net), jw, None)
    w = _seeded(5, lambda: make_model("dptnet", device="cpu", **DPTNET))
    out["dptnet"] = (_write(d / "dptnet.ckpt", w.module.state_dict()), "dptnet",
                     lambda: make_model("dptnet", device="cpu", **DPTNET),
                     jax_make_model("dptnet", **DPTNET), w)
    w = _seeded(6, lambda: make_cnn14(device="cpu"))
    out["cnn14"] = (_write(d / "cnn14.ckpt", w.state_dict(), "network."), "cnn14",
                    lambda: make_cnn14(device="cpu"), jax_make_cnn14(), w)
    return out


CASES = ["tcn", "umx", "demucs_torchaudio", "demucs_upstream", "dcunet_bN",
         "dcunet_CbN", "dcunet_trained", "dptnet", "cnn14"]


def _jax_out(jmodel, variables, x, kind):
    if kind == "cnn14":
        return np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x[:, 0])))
    return np.asarray(jax.jit(jmodel.sample)(variables, jnp.asarray(x)))


def _port_out(model, x, kind):
    with torch.no_grad():
        xt = torch.from_numpy(x)
        return (model(xt[:, 0]) if kind == "cnn14" else model.sample(xt)).numpy()


@pytest.mark.parametrize("case", CASES)
def test_import_matches_jax(files, case):
    path, kind, build, jmodel, source = files[case]
    x = _audio(seed=CASES.index(case), length=16384 if kind == "cnn14" else T)
    kind_j, variables = jti.import_torch_checkpoint(str(path))
    kind_t, sd = tti.import_torch_checkpoint(path)
    assert kind_j == kind_t == kind
    if kind == "umx":
        # the JAX tree is the OpenUnmix's; its separator holds it as "model"
        variables = {group: {"model": tree} for group, tree in variables.items()}
    init = jax.jit(jmodel.init) if kind == "cnn14" else jmodel.init
    template = _np(init(jax.random.PRNGKey(9), jnp.asarray(x[:, 0] if kind == "cnn14" else x)))
    jti.check_structure(variables, template)
    want = _jax_out(jmodel, variables, x, kind)
    model = build()
    assert load_torch_checkpoint(path, model) == kind
    got = _port_out(model, x, kind)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if source is not None:
        np.testing.assert_array_equal(got, _port_out(source, x, kind))


def test_jax_umx_import_is_rooted_at_the_network(files):
    """The JAX package's own structure check refuses its UMX import as it
    comes (ROADMAP.md §C); the port's names are the separator's."""
    path, _, build, jmodel, _ = files["umx"]
    _, variables = jti.import_torch_checkpoint(str(path))
    template = _np(jmodel.init(jax.random.PRNGKey(9), jnp.zeros((1, 1, 4096))))
    with pytest.raises(ValueError, match="structure mismatch"):
        jti.check_structure(variables, template)
    _, sd = tti.import_torch_checkpoint(path)
    assert set(sd) == set(build().module.state_dict())


def test_cnn14_bn0_is_skipped(files, caplog):
    """The reference's Cnn14 has an unused bn0: the JAX import carries it
    into bn0_unused, which its structure check refuses; the port skips
    it, logged by name, and loads the rest."""
    path, _, build, jmodel, source = files["cnn14"]
    sd = torch.load(path, weights_only=True)["state_dict"]
    bn0 = {"network.bn0.weight": torch.ones(64), "network.bn0.bias": torch.zeros(64),
           "network.bn0.running_mean": torch.zeros(64),
           "network.bn0.running_var": torch.ones(64),
           "network.bn0.num_batches_tracked": torch.tensor(0)}
    np_sd = jti.strip_prefix({k: v.numpy() for k, v in {**sd, **bn0}.items()})
    variables = jti.convert_cnn14(np_sd)
    assert "bn0_unused" in variables["params"]
    template = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(9), jnp.zeros((1, 16384))))
    with pytest.raises(ValueError, match="bn0_unused"):
        jti.check_structure(variables, template)
    with caplog.at_level(logging.INFO, logger="remfx_tpu_torch.compat.torch_import"):
        kept = tti.RENAMES["cnn14"](tti.strip_prefix({**sd, **bn0}))
    assert not any(k.startswith("bn0") for k in kept)
    assert all(f"skips {k[len('network.'):]}" in caplog.text for k in bn0)
    assert kept.keys() == source.state_dict().keys()


@pytest.mark.parametrize("sd", [
    {"masker.encoders.0.conv.re_module.weight": 0}, {"encoder.0.conv.weight": 0},
    {"tencoder.0.conv.weight": 0}, {"freq_emb.embedding.weight": 0},
    {"conv_block1.conv1.weight": 0}, {"process_blocks.0.conv1.weight": 0},
    {"masker.layers.0.0.mha.in_proj_weight": 0, "encoder.filterbank._filters": 0},
    {"lstm.weight_ih_l0": 0}, {"fc1.weight": 0}, {"mystery.weight": 0}],
    ids=lambda sd: next(iter(sd)))
def test_detect_kind_matches_jax(sd):
    try:
        want = jti.detect_kind(sd)
    except ValueError:
        with pytest.raises(ValueError, match="unrecognized"):
            tti.detect_kind(sd)
        return
    assert tti.detect_kind(sd) == want


def test_strip_prefix_matches_jax():
    sd = {"model.model.a": 1, "model.b": 2, "network.c": 3, "other.d": 4,
          "model.model.model.e": 5}
    assert tti.strip_prefix(sd) == jti.strip_prefix(sd) == {
        "a": 1, "b": 2, "c": 3, "other.d": 4, "model.e": 5}


def test_demucs_naming_styles_give_one_state_dict(files):
    """upstream's encoder / tencoder / decoder / tdecoder are torchaudio's
    freq_encoder / time_encoder / freq_decoder / time_decoder."""
    sds = {s: tti.import_torch_checkpoint(files[f"demucs_{s}"][0])[1]
           for s in ("torchaudio", "upstream")}
    raw = torch.load(files["demucs_upstream"][0], weights_only=True)["state_dict"]
    assert any(k.startswith("model.model.tencoder.") for k in raw)
    assert sds["torchaudio"].keys() == sds["upstream"].keys()
    assert all(torch.equal(v, sds["upstream"][k]) for k, v in sds["torchaudio"].items())
    assert any(k.startswith("time_encoder.") for k in sds["upstream"])


def test_missing_parameter_raises(files, tmp_path):
    path, _, build, _, _ = files["tcn"]
    sd = torch.load(path, weights_only=True)["state_dict"]
    del sd["model.model.output.bias"]
    short = tmp_path / "short.ckpt"
    torch.save({"state_dict": sd}, short)
    with pytest.raises(RuntimeError, match="output.bias"):
        load_torch_checkpoint(short, build())


def test_unknown_key_is_logged_by_name(files, tmp_path, caplog):
    path, _, build, _, source = files["tcn"]
    sd = torch.load(path, weights_only=True)["state_dict"]
    sd["model.model.mystery.weight"] = torch.zeros(3)
    extra = tmp_path / "extra.ckpt"
    torch.save({"state_dict": sd}, extra)
    model = build()
    with caplog.at_level(logging.INFO, logger="remfx_tpu_torch.compat.torch_import"):
        load_torch_checkpoint(extra, model)
    assert "skips mystery.weight" in caplog.text
    assert all(torch.equal(v, source.state_dict()[k])
               for k, v in model.state_dict().items())


class Pickled:
    pass


def test_pickled_class_is_refused(files, tmp_path):
    path, _, build, _, _ = files["tcn"]
    obj = torch.load(path, weights_only=True)
    obj["hyper_parameters"] = Pickled()
    bad = tmp_path / "pickled.ckpt"
    torch.save(obj, bad)
    with pytest.raises(ValueError, match=r"pickled\.ckpt.*Pickled"):
        load_torch_checkpoint(bad, build())


def test_wrong_family_and_norm_raise(files):
    with pytest.raises(ValueError, match="holds a tcn checkpoint; the model is dptnet"):
        load_torch_checkpoint(files["tcn"][0], files["dptnet"][2]())
    with pytest.raises(ValueError, match="norm_type 'CbN'"):
        load_torch_checkpoint(files["dcunet_CbN"][0], files["dcunet_bN"][2]())


# ------------------------------------------------------------------ build_chain

def _chain_cfg(tmp_path, files):
    """remfx_detect with every slot and the classifier a .ckpt file, at
    small widths; HDemucs residual through identity_init."""
    d = tmp_path
    jw = jax_make_model("demucs", identity_init=True, **DEMUCS)
    v = _np(jw.init(jax.random.PRNGKey(7), jnp.zeros((1, 1, 4096))))
    v["params"] = jax.tree.map(lambda a: a + np.float32(0.01), v["params"])
    paths = {"RandomPedalboardDistortion": (files["tcn"][0], "tcn", TCN),
             "RandomPedalboardCompressor": (
                 _write(d / "demucs.ckpt", jti.export_demucs(v)), "demucs",
                 dict(identity_init=True, **DEMUCS))}
    for i, slot in enumerate(("Reverb", "Chorus", "Delay")):
        w = _seeded(20 + i, lambda: make_model("dcunet", device="cpu", **DCUNET))
        paths[f"RandomPedalboard{slot}"] = (
            _write(d / f"dcunet_{slot}.ckpt", w.module.state_dict()), "dcunet", DCUNET)
    cfg = parse_cli(["+exp=remfx_detect"])
    cfg["ckpts"] = {k: {"model": {"name": name, "network": copy.deepcopy(net)},
                        "ckpt_path": str(p)} for k, (p, name, net) in paths.items()}
    cfg["classifier_ckpt"] = str(files["cnn14"][0])
    return cfg


def test_build_chain_from_ckpt_files_matches_jax(files, tmp_path, monkeypatch):
    monkeypatch.delenv("REMFX_ALLOW_RANDOM_CKPT", raising=False)
    cfg = _chain_cfg(tmp_path, files)
    x = _audio(seed=30, length=T)
    y = (0.5 * np.tanh(2 * x)).astype(np.float32)
    jc = jax_build_chain(copy.deepcopy(cfg), jnp.asarray(x))
    pc = build_chain(copy.deepcopy(cfg), None, device="cpu")
    comp = pc.models["RandomPedalboardCompressor"]
    assert comp.residual and type(comp.module).__name__ == "HDemucs"
    labels_j = np.asarray(jc.detect(jnp.asarray(x)))
    labels_t = pc.detect(torch.from_numpy(x))
    np.testing.assert_array_equal(labels_t.numpy(), labels_j)
    oracle = np.ones_like(labels_j)
    want = jc.test_step(tuple(jnp.asarray(a) for a in (x, y, oracle, oracle)))
    got = pc.test_step(tuple(torch.from_numpy(a) for a in (x, y, oracle, oracle)))
    assert pc.effect_order == tuple(jc.effect_order)
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert abs(g - w) <= 1e-4 * max(abs(w), 1.0), (k, g, w)
