"""The port's chain builder and trained loaders against the JAX package's.

``chain/build.py:build_chain`` with the vendored map (demo_detect's: the
trained TCN, HDemucs and three Large-DCUNet-20, and the trained Cnn14)
gives the labels of JAX's ``build_chain`` and its removal to 1e-4 x the
RMS of the JAX output, at 16384 samples of two demo clips. Its rules: a
missing ckpt raises unless ``REMFX_ALLOW_RANDOM_CKPT=1``, which draws
reproducible seeded weights; a vendored ckpt of another effect raises; a
file that is no torch checkpoint raises, naming it; an orbax directory without
``hparams.json`` is restored into the slot's model. The trained loaders
equal ``compat/from_jax.py`` fed by the JAX loaders, bit for bit, and
``warm_start`` takes an orbax donor.
"""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.build import build_chain as jax_build_chain
from remfx_tpu.train import checkpoint as jax_checkpoint
from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.cli.demo_detect import trained_cfg
from remfx_tpu_torch.compat import from_jax
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.config.experiments import EXPERIMENTS
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.train.checkpoint import (load_trained_classifier,
                                              load_trained_wrapper, restore_tree,
                                              warm_start)
from remfx_tpu_torch.train.loop import build_task

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY_TCN = {"name": "tcn", "network": {"nblocks": 3, "channel_width": 8,
                                       "kernel_size": 3, "dilation_growth": 2}}
CHAIN_EXPERIMENTS = sorted(k for k in EXPERIMENTS
                           if k.startswith(("chain_inference", "remfx_")))
BRIDGES = {"tcn": from_jax.tcn_state_dict, "dcunet": from_jax.dcunet_state_dict,
           "demucs": from_jax.demucs_state_dict}


@pytest.fixture
def in_repo(monkeypatch):
    """The vendored map's paths are relative to the repository root."""
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("REMFX_ALLOW_RANDOM_CKPT", raising=False)


def _demo(T):
    x, _ = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    y, _ = read_wav(ROOT / "demos" / "synth_distortion_reverb.wav")
    return np.stack([x[:, :T], y[:, :T]]).astype(np.float32)  # (2, 1, T)


def test_vendored_chain_matches_jax(in_repo):
    cfg = trained_cfg(parse_cli(["+exp=remfx_detect"]))
    assert len(cfg["ckpts"]) == 5
    x = _demo(16384)
    port = build_chain(copy.deepcopy(cfg), None, device="cpu")
    jc = jax_build_chain(copy.deepcopy(cfg), jnp.asarray(x))
    assert port.effect_order == tuple(jc.effect_order)
    assert port.shuffle_effect_order and not port.use_all_effect_models
    labels_j = np.asarray(jc.detect(jnp.asarray(x)))
    labels_t = port.detect(torch.from_numpy(x))
    np.testing.assert_array_equal(labels_t.numpy(), labels_j)
    want = np.asarray(jc.remove(jnp.asarray(x), jnp.asarray(labels_j))[0])
    got = port.remove(torch.from_numpy(x), labels_t)[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want**2))


def _tiny_cfg(**ckpts):
    cfg = parse_cli(["+exp=remfx_oracle"])
    cfg["ckpts"] = {k: {"model": copy.deepcopy(TINY_TCN), "ckpt_path": v}
                    for k, v in ckpts.items()}
    return cfg


def test_missing_ckpt_raises(in_repo, tmp_path):
    cfg = _tiny_cfg(RandomPedalboardDistortion=str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="REMFX_ALLOW_RANDOM_CKPT"):
        build_chain(cfg, None, device="cpu")
    cfg = parse_cli(["+exp=remfx_detect"])  # the reference's .ckpt paths
    with pytest.raises(FileNotFoundError, match="missing"):
        build_chain(cfg, None, device="cpu")


def test_random_weights_are_seeded_and_reproducible(in_repo, monkeypatch, tmp_path):
    monkeypatch.setenv("REMFX_ALLOW_RANDOM_CKPT", "1")
    absent = str(tmp_path / "absent")
    before = torch.random.get_rng_state()
    a = build_chain(_tiny_cfg(RandomPedalboardDistortion=absent,
                              RandomPedalboardReverb=absent), None, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)
    b = build_chain(_tiny_cfg(RandomPedalboardDistortion=absent,
                              RandomPedalboardReverb=absent), None, device="cpu")
    other = _tiny_cfg(RandomPedalboardDistortion=absent,
                      RandomPedalboardReverb=absent)
    other["seed"] += 1
    c = build_chain(other, None, device="cpu")
    for slot in a.models:
        sa, sb, sc = (ch.models[slot].state_dict() for ch in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    # each slot draws its own seed
    w = [a.models[s].module.output.weight for s in a.models]
    assert not torch.equal(w[0], w[1])


def test_vendored_ckpt_of_another_effect_raises(in_repo):
    cfg = _tiny_cfg(RandomPedalboardReverb="ckpts/tcn_distortion_aug")
    with pytest.raises(ValueError, match="removes 'distortion'"):
        build_chain(cfg, None, device="cpu")


@pytest.mark.parametrize("slot", ["RandomPedalboardDistortion", "classifier"])
def test_torch_ckpt_file_names_roadmap(in_repo, tmp_path, slot):
    """A torch ``.ckpt`` file is imported now (ROADMAP.md §A11,
    compat/torch_import.py; tests/test_torch_import.py): one that is no
    torch checkpoint raises, naming the file."""
    f = tmp_path / "demucs_distortion_aug.ckpt"
    f.write_bytes(b"not read")
    if slot == "classifier":
        cfg = parse_cli(["+exp=remfx_detect", "ckpts={}", f"classifier_ckpt={f}"])
    else:
        cfg = _tiny_cfg(RandomPedalboardDistortion=str(f))
    with pytest.raises(ValueError, match="demucs_distortion_aug.ckpt: not a checkpoint"):
        build_chain(cfg, None, device="cpu")


def test_orbax_directory_is_restored_into_the_slot_model(in_repo):
    """A slot's ckpt_path that is an orbax directory with no hparams.json:
    the weights go into the model the slot names."""
    cfg = parse_cli(["+exp=remfx_oracle"])
    cfg["ckpts"] = {"RandomPedalboardDistortion": {
        "model": {"name": "tcn", "network": {"nblocks": 10, "channel_width": 64}},
        "ckpt_path": "ckpts/tcn_distortion_aug/variables"}}
    chain = build_chain(cfg, None, device="cpu")
    _, want = load_trained_wrapper("ckpts/tcn_distortion_aug", device="cpu")
    got = chain.models["RandomPedalboardDistortion"].state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())


@pytest.mark.parametrize("name", CHAIN_EXPERIMENTS)
def test_chain_experiments_build(in_repo, monkeypatch, name):
    """Every chain experiment builds (random weights allowed; every slot
    a tiny TCN, so that the test stays cheap) with its order, shuffle,
    use_all and classifier."""
    monkeypatch.setenv("REMFX_ALLOW_RANDOM_CKPT", "1")
    cfg = parse_cli([f"+exp={name}"])
    for spec in cfg["ckpts"].values():
        spec["model"] = copy.deepcopy(TINY_TCN)
    chain = build_chain(cfg, None, device="cpu")
    assert set(chain.models) == set(cfg["ckpts"])
    assert chain.effect_order == tuple(cfg["inference_effects_ordering"])
    assert chain.shuffle_effect_order == cfg["inference_effects_shuffle"]
    assert chain.use_all_effect_models == cfg["inference_use_all_effect_models"]
    assert (chain.classifier is not None) == ("classifier" in cfg)


TRAINED = ["tcn_distortion_aug", "tcn_distortion_synth", "dcunet_reverb_aug_r4",
           "dcunet_reverb_aug_240", "dcunet_chorus_aug_r5", "dcunet_delay_aug_r5",
           "demucs_compressor_aug_r5"]


@pytest.mark.parametrize("name", TRAINED)
def test_load_trained_wrapper_equals_jax_loader(name):
    d = ROOT / "ckpts" / name
    effect, wrapper = load_trained_wrapper(d, device="cpu")
    jeffect, _, variables = jax_checkpoint.load_trained_wrapper(str(d))
    assert effect == jeffect
    kind = json.loads((d / "hparams.json").read_text())["model"]["name"]
    want = BRIDGES[kind](variables)
    got = wrapper.module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert not wrapper.training


@pytest.mark.parametrize("name", ["classifier_cnn14", "classifier_cnn14_r5"])
def test_load_trained_classifier_equals_jax_loader(name):
    d = ROOT / "ckpts" / name
    net = load_trained_classifier(d, device="cpu")
    _, variables = jax_checkpoint.load_trained_classifier(str(d))
    want = from_jax.cnn14_state_dict(variables)
    got = net.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_loaders_check_what_the_jax_loaders_assert(tmp_path):
    with pytest.raises(ValueError, match="not a classifier ckpt"):
        load_trained_classifier(ROOT / "ckpts" / "tcn_distortion_aug", device="cpu")
    d = tmp_path / "two"
    d.mkdir()
    hp = json.loads((ROOT / "ckpts" / "tcn_distortion_aug" / "hparams.json").read_text())
    hp["effects_to_remove"] = ["distortion", "reverb"]
    (d / "hparams.json").write_text(json.dumps(hp))
    with pytest.raises(ValueError, match="single-effect"):
        load_trained_wrapper(d, device="cpu")


def test_model_the_port_lacks_raises_but_its_tree_reads():
    """ckpts/umx_reverb_synth, whose model the port once lacked: its tree
    reads, and with UMX ported (tests/test_torch_umx.py holds it against
    JAX) the loader builds it."""
    d = ROOT / "ckpts" / "umx_reverb_synth"
    effect, wrapper = load_trained_wrapper(d, device="cpu")
    assert effect == "reverb" and type(wrapper.module).__name__ == "UMXSeparator"
    assert restore_tree(d / "variables")["params"]


def _tcn_state(seed=0):
    cfg = parse_cli(["+exp=distortion", "model.name=tcn", "accelerator=cpu",
                     "model.network.nblocks=10", "model.network.channel_width=64",
                     f"seed={seed}"])
    return build_task(cfg, device="cpu").init_state()


@pytest.mark.parametrize("donor", ["tcn_distortion_aug/variables",
                                   "tcn_distortion_synth/best"])
def test_warm_start_from_an_orbax_donor(donor):
    """A vendored params-only tree (bfloat16 params) and a JAX run's full
    TrainState (fp32 params and the optimizer's moments): the params come
    over, the optimizer and counters stay fresh."""
    state = _tcn_state()
    warm_start(str(ROOT / "ckpts" / donor), state)
    name = donor.split("/")[0]
    _, want = load_trained_wrapper(ROOT / "ckpts" / name, device="cpu")
    got = state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())
    assert state.step == 0 and not state.optimizer.state
