"""Detect -> remove chain of the port against the JAX package, weights
carried from JAX inits, with a full-width Cnn14 as classifier:

* one slot: the small HDemucs of ``test_torch_demucs.py`` in the
  compressor slot;
* five slots: a small TCN (distortion; 4 blocks, width 8, kernel 7, 90
  samples shorter), that HDemucs (compressor) and three Mini-DCUNet-6
  (reverb, chorus, delay; stft kernel 64, identity_init), on 16 rows so
  that the regroup dispatch has both a sub-batch (bucket 8) and a dense
  stage; then ``forward`` / ``test_step`` and the dispatch modes.

Tolerance: 1e-4 x the RMS of the JAX output for audio; labels equal;
losses and metrics 1e-4 relative (1e-4 absolute for a metric near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.fx.compressor import render_batch as jax_render_batch
from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models.dcunet import DCUNet as JaxDCUNet
from remfx_tpu.models.demucs import HDemucs as JaxHDemucs
from remfx_tpu.models.tcn import TCN as JaxTCN
from remfx_tpu.models.wrappers import ModelWrapper as JaxWrapper
from remfx_tpu.utils.regroup import bucket_size as jax_bucket_size
from remfx_tpu.utils.regroup import bucketed_indices as jax_bucketed_indices
from remfx_tpu_torch import ALL_EFFECTS, EFFECT_CLASS_NAMES
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.compat.from_jax import (cnn14_state_dict, dcunet_state_dict,
                                             demucs_state_dict, tcn_state_dict)
from remfx_tpu_torch.fx.compressor import render_batch
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.utils.regroup import bucket_size, bucketed_indices

torch.set_num_threads(2)
CFG = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64,
           depth=3, norm_starts=1, dconv_lstm=2, dconv_attn=1)
SR = 48000
B, T = 2, 8192
TOL = 1e-4
SLOT = "RandomPedalboardCompressor"
COMP = ALL_EFFECTS.index("compressor")


@pytest.fixture(scope="module")
def classifier():
    net = jax_make_cnn14()
    cv = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((B, T))))
    cls = make_cnn14(device="cpu")
    cls.load_state_dict(cnn14_state_dict(cv), strict=True)
    return net, cv, cls


@pytest.fixture(scope="module")
def chains(classifier):
    net, cv, cls = classifier
    jw = JaxWrapper(JaxHDemucs(**CFG), takes_train_flag=True, residual=True)
    dv = jax.device_get(jw.init(jax.random.PRNGKey(1), jnp.zeros((B, 1, T))))
    dm = HDemucs(**CFG)
    dm.load_state_dict(demucs_state_dict(dv), strict=True)
    tw = ModelWrapper(dm, residual=True)

    def both(**kw):
        jax_chain = JaxChain({SLOT: (jw, dv)}, SR, classifier=(net, cv),
                             dispatch="staged", **kw)
        port_chain = ChainInference({SLOT: tw}, SR, classifier=cls, **kw)
        return jax_chain, port_chain

    return both


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, T)).astype(np.float32)
    x *= np.linspace(0.2, 1.0, T, dtype=np.float32)
    return (0.3 * x).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.sqrt(np.mean(want**2))


def test_detect_matches_jax(chains):
    jc, pc = chains()
    x = _audio()
    want = np.asarray(jc.detect(jnp.asarray(x)))
    got = pc.detect(torch.from_numpy(x)).numpy()
    assert got.shape == (B, len(ALL_EFFECTS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask", [(1.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
def test_oracle_remove_matches_jax(chains, mask):
    jc, pc = chains()
    x = _audio(seed=1)
    labels = np.zeros((B, len(ALL_EFFECTS)), np.float32)
    labels[:, COMP] = mask
    want, _ = jc.remove(jnp.asarray(x), jnp.asarray(labels))
    got, _ = pc.remove(torch.from_numpy(x), torch.from_numpy(labels))
    _close(got.numpy(), np.asarray(want))
    for i, m in enumerate(mask):  # unselected examples pass through untouched
        if not m:
            np.testing.assert_array_equal(got[i].numpy(), x[i])


def test_use_all_effect_models_matches_jax(chains):
    jc, pc = chains(use_all_effect_models=True)
    x = _audio(seed=2)
    xj = jnp.asarray(x)
    want = np.asarray(jc.sample((xj, xj, None, jnp.zeros((B, len(ALL_EFFECTS))))))
    got, labels = pc.run(torch.from_numpy(x))
    assert torch.equal(labels, torch.ones(B, len(ALL_EFFECTS)))
    _close(got.numpy(), want)


def test_all_equals_oracle_with_the_compressor_label(chains):
    """Dispatch consistency (BASELINE.md:236): with only the compressor
    slot loaded, "all" and oracle-with-compressor-label are bit-equal."""
    _, pc_all = chains(use_all_effect_models=True)
    _, pc = chains()
    x = torch.from_numpy(_audio(seed=3))
    labels = torch.zeros(B, len(ALL_EFFECTS))
    labels[:, COMP] = 1.0
    y_all, _ = pc_all.run(x)
    y_oracle, _ = pc.remove(x, labels)
    assert torch.equal(y_all, y_oracle)


def test_render_detect_remove_slice_matches_jax(chains):
    """The slice end to end on the CPU: compressor render -> Cnn14 detect
    -> HDemucs removal, port against JAX."""
    jc, pc = chains()
    x = _audio(seed=4)
    params = {
        "threshold_db": np.array([-35.0, -22.0], np.float32),
        "ratio": np.array([5.0, 2.0], np.float32),
        "attack_ms": np.array([2.0, 30.0], np.float32),
        "release_ms": np.array([50.0, 200.0], np.float32),
    }
    wet_j = jax_render_batch(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, SR)
    wet_t = render_batch(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}, SR)
    _close(wet_t.numpy(), np.asarray(wet_j))
    labels_j = jc.detect(wet_j)
    labels_t = pc.detect(wet_t)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    # the seeded classifier may detect nothing: switch the compressor on
    # for one example so the removal stage runs in both packages
    labels_j = labels_j.at[0, COMP].set(1.0)
    labels_t[0, COMP] = 1.0
    want, _ = jc.remove(wet_j, labels_j)
    got, _ = pc.remove(wet_t, labels_t)
    _close(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()


# ------------------------------------------------------------ five slots

B5 = 16  # rows: the regroup dispatch needs B > 8 for a sub-batch bucket
TCN_CFG = dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2)
DCUNET_CFG = dict(architecture="Mini-DCUNet-6", stft_kernel_size=64,
                  identity_init=True)
SLOT_OF = {EFFECT_CLASS_NAMES[name]: name for name in DEFAULT_ORDER}
REL = 1e-4


@pytest.fixture(scope="module")
def five(classifier):
    """-> build(**kw) returning a (JAX chain, port chain) pair over the
    same five slots."""
    net, cv, cls = classifier
    x0 = jnp.zeros((2, 1, T))
    jaxs, ports = {}, {}
    jw = JaxWrapper(JaxTCN(**TCN_CFG))
    v = jax.device_get(jw.init(jax.random.PRNGKey(2), x0))
    port = TCN(**TCN_CFG)
    port.load_state_dict(tcn_state_dict(v), strict=True)
    jaxs[SLOT_OF["distortion"]] = (jw, v)
    ports[SLOT_OF["distortion"]] = ModelWrapper(port)
    jw = JaxWrapper(JaxHDemucs(**CFG), takes_train_flag=True, residual=True)
    v = jax.device_get(jw.init(jax.random.PRNGKey(3), x0))
    port = HDemucs(**CFG)
    port.load_state_dict(demucs_state_dict(v), strict=True)
    jaxs[SLOT] = (jw, v)
    ports[SLOT] = ModelWrapper(port, residual=True)
    for seed, effect in enumerate(("reverb", "chorus", "delay"), start=4):
        jw = JaxWrapper(JaxDCUNet(**DCUNET_CFG), takes_train_flag=True)
        v = jax.device_get(jw.init(jax.random.PRNGKey(seed), x0))
        v["params"]["mask_bias"] = np.array([1.0 + 0.1 * seed, -0.2], np.float32)
        port = DCUNet(**DCUNET_CFG)
        port.load_state_dict(dcunet_state_dict(v), strict=True)
        jaxs[SLOT_OF[effect]] = (jw, v)
        ports[SLOT_OF[effect]] = ModelWrapper(port)

    def build(with_classifier=False, **kw):
        jc = JaxChain(jaxs, SR, classifier=(net, cv) if with_classifier else None,
                      **{"dispatch": "staged", **kw})
        pc = ChainInference(ports, SR, classifier=cls if with_classifier else None,
                            **kw)
        return jc, pc

    return build


def _labels(counts: dict, rows=B5):
    """(rows, 5) labels with ``counts[effect]`` rows on, spread out."""
    labels = np.zeros((rows, len(ALL_EFFECTS)), np.float32)
    for effect, n in counts.items():
        j = ALL_EFFECTS.index(effect)
        picked = [(i * (2 * j + 3) + j) % rows for i in range(rows)][:n]
        labels[picked, j] = 1.0
        assert labels[:, j].sum() == n
    return labels


def _batch(rows=B5, seed=10):
    rng = np.random.default_rng(seed)
    y = (0.3 * rng.standard_normal((rows, 1, T))).astype(np.float32)
    x = (y + 0.1 * rng.standard_normal((rows, 1, T))).astype(np.float32)
    return x, y


def _rel(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= REL * max(abs(want), 1.0), (got, want)


# distortion 0 rows: the TCN is skipped but its crop applies;
# 5 and 8 rows: a bucket of 8 (sub-batch); 12 and 14: the dense stage
MIXED = {"distortion": 0, "compressor": 5, "reverb": 14, "chorus": 8, "delay": 12}
MIXED_TCN_ON = {"distortion": 3, "compressor": 16, "reverb": 0, "chorus": 6, "delay": 13}


@pytest.mark.parametrize("counts", [MIXED, MIXED_TCN_ON], ids=["tcn_off", "tcn_on"])
def test_five_slot_oracle_remove_matches_jax(five, counts):
    jc, pc = five()
    x, _ = _batch()
    labels = _labels(counts)
    want, _ = jc.remove(jnp.asarray(x), jnp.asarray(labels))
    got, _ = pc.remove(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.shape == (B5, 1, T - 90)
    _close(got.numpy(), np.asarray(want))


def test_five_slot_all_matches_jax_and_equals_oracle(five):
    jc, pc = five(use_all_effect_models=True)
    x, y = _batch(rows=4)
    xj = jnp.asarray(x)
    want = np.asarray(jc.sample((xj, jnp.asarray(y), None, jnp.zeros((4, 5)))))
    got, labels = pc.run(torch.from_numpy(x))
    assert torch.equal(labels, torch.ones(4, len(ALL_EFFECTS)))
    _close(got.numpy(), want)
    _, oracle = five()
    y_oracle, _ = oracle.remove(torch.from_numpy(x), torch.ones(4, len(ALL_EFFECTS)))
    assert torch.equal(got, y_oracle)


def test_five_slot_detect_matches_jax(five):
    """Classifier labels, then the five stages: forward's output, loss
    and labels as JAX's."""
    jc, pc = five(with_classifier=True)
    x, y = _batch(rows=4, seed=11)
    batch_j = (jnp.asarray(x), jnp.asarray(y), None, jnp.zeros((4, 5)))
    np.testing.assert_array_equal(pc.detect(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc.detect(batch_j[0])))
    want_loss, want = jc.forward(batch_j)
    loss, got = pc.forward((torch.from_numpy(x), torch.from_numpy(y), None,
                            torch.zeros(4, 5)))
    _close(got.numpy(), np.asarray(want))
    _rel(loss, want_loss)


def test_forward_and_test_step_match_jax(five):
    jc, pc = five()
    x, y = _batch(seed=12)
    labels = _labels(MIXED_TCN_ON)
    batch_j = tuple(jnp.asarray(a) for a in (x, y, labels, labels))
    batch_t = tuple(torch.from_numpy(a) for a in (x, y, labels, labels))
    want_loss, want = jc.forward(batch_j)
    loss, got = pc.forward(batch_t)
    _close(got.numpy(), np.asarray(want))
    _rel(loss, want_loss)
    want_m = jc.test_step(batch_j)
    got_m = pc.test_step(batch_t)
    assert set(got_m) == set(want_m) == {
        "test_loss", "test_SISDR", "test_STFT", "Input_SISDR", "Input_STFT"}
    for k in want_m:
        _rel(got_m[k], want_m[k])
    _close(pc.sample(batch_t).numpy(), np.asarray(want))


@pytest.mark.parametrize("counts", [MIXED, MIXED_TCN_ON], ids=["tcn_off", "tcn_on"])
def test_regroup_matches_jax_regroup_and_single(five, counts):
    """An empty slot (crop without compute), sub-batch slots and dense
    slots: regroup against JAX's regroup and against single."""
    jc, pc = five(dispatch="regroup")
    _, single = five()
    x, y = _batch(seed=13)
    labels = _labels(counts)
    batch_j = tuple(jnp.asarray(a) for a in (x, y, labels, labels))
    batch_t = tuple(torch.from_numpy(a) for a in (x, y, labels, labels))
    kinds = {e: ("empty" if n == 0 else
                 "sub" if (bucket_size(n, B5) or B5) < B5 else "dense")
             for e, n in counts.items()}
    assert {"empty", "sub", "dense"} <= set(kinds.values()), kinds
    want_loss, want = jc.forward(batch_j)
    loss, got = pc.forward(batch_t)
    assert got.shape == (B5, 1, T - 90)
    _close(got.numpy(), np.asarray(want))
    _rel(loss, want_loss)
    y_single, _ = single.remove(batch_t[0], batch_t[3])
    _close(got.numpy(), y_single.numpy())
    for i in np.flatnonzero(labels.sum(axis=1) == 0):  # untouched rows
        np.testing.assert_array_equal(got[i].numpy(), y_single[i].numpy())


def test_dispatch_modes_agree_bit_for_bit_with_every_label_on(five):
    x, _ = _batch(rows=4, seed=14)
    labels = torch.ones(4, len(ALL_EFFECTS))
    outs = [five(dispatch=d)[1].run(torch.from_numpy(x), labels)[0]
            for d in ("single", "staged", "regroup")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_shuffled_effect_order_sequence_matches_jax():
    """test_step shuffles effect_order in place from random.Random(seed):
    the same sequence of orders as the JAX package (no slots loaded, so
    the chain passes audio through)."""
    x, y = _batch(rows=2)
    labels = np.zeros((2, 5), np.float32)
    jc = JaxChain({}, SR, shuffle_effect_order=True, seed=7, dispatch="staged")
    pc = ChainInference({}, SR, shuffle_effect_order=True, seed=7)
    seen = []
    for _ in range(4):
        jc.test_step(tuple(jnp.asarray(a) for a in (x, y, labels, labels)))
        pc.test_step(tuple(torch.from_numpy(a) for a in (x, y, labels, labels)))
        assert pc.effect_order == jc.effect_order
        seen.append(pc.effect_order)
    assert len(set(seen)) > 1


def test_bucket_size_and_indices_match_jax():
    for max_size in (1, 2, 8, 9, 16, 17, 32, 64):
        for n in range(1, max_size + 1):
            for g in (1, 4, 8):
                assert bucket_size(n, max_size, g) == jax_bucket_size(n, max_size, g)
        for n in range(1, max_size + 1):
            sel = np.arange(0, 2 * n, 2)
            np.testing.assert_array_equal(bucketed_indices(sel, max_size),
                                          jax_bucketed_indices(sel, max_size))
    for fn in (bucket_size, jax_bucket_size):
        with pytest.raises(ValueError):
            fn(0, 8)


def test_unknown_dispatch_mode_raises():
    with pytest.raises(ValueError, match="dispatch"):
        ChainInference({}, SR, dispatch="pipeline")


def test_verbose_forward_names_the_detected_effects_as_jax(five, capsys):
    jc, pc = five()
    x, y = _batch(rows=2, seed=15)
    labels = np.zeros((2, 5), np.float32)
    labels[0, [ALL_EFFECTS.index("reverb"), ALL_EFFECTS.index("distortion")]] = 1.0
    jc.forward(tuple(jnp.asarray(a) for a in (x, y, labels, labels)), verbose=True)
    want = capsys.readouterr().out
    pc.forward(tuple(torch.from_numpy(a) for a in (x, y, labels, labels)), verbose=True)
    got = capsys.readouterr().out
    assert got == want
    assert "RandomPedalboardDistortion" in got and "RandomPedalboardReverb" in got
