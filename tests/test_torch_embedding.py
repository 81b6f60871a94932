"""The port's frozen-embedding classifiers (``models/embedding_classifiers.py``)
and ``cls_panns_pt`` training against the JAX package's
``remfx_tpu/models/embedding_classifiers.py``.

Weights go across with ``compat/from_jax.py:embedding_classifier_state_dicts``
(the head's Dense kernels transposed; the PANNs trunk through
``cnn14_state_dict``). Tolerances:

  * a stub embedding (``x[:, :8]``): 1e-6 of the logits' peak (three small
    fp32 matrix products);
  * the PANNs classifier (Cnn14 trunk at 32 kHz after a 48 -> 32 kHz
    resample): 1e-5 of the logits' peak (measured 3.8e-6), the tolerance of
    the port's Cnn14 against JAX;
  * one fp32 ``ClassifierTask`` step of ``cls_panns_pt`` (cross-entropy with
    label smoothing, clip, AdamW): the loss within 1e-5, relative
    (measured equal); the head's parameters after the step within 0.1 lr
    of JAX's (measured 0.0097 lr; Adam moves each by about lr, 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import embedding_classifiers as jemb
from remfx_tpu.models.cnn14 import Cnn14 as JCnn14
from remfx_tpu.train import tasks as jtasks
from remfx_tpu_torch.compat.from_jax import embedding_classifier_state_dicts
from remfx_tpu_torch.config import core as tcore
from remfx_tpu_torch.models import embedding_classifiers as temb
from remfx_tpu_torch.train import tasks as ttasks
from remfx_tpu_torch.train.checkpoint import read_state
from remfx_tpu_torch.train.loop import build_task, fit

torch.set_num_threads(2)
SR = 48000
LR = 3e-4


def _audio(rows=2, C=1, T=16384, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, C, T)) * np.linspace(0.2, 1.0, T)
    return (0.3 * x).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def panns():
    """The JAX PANNs classifier (trunk as ``make_panns_embed_fn`` draws it,
    a head from key 1) and the port's with both carried across."""
    net = JCnn14(num_classes=5, sample_rate=32000, model_sample_rate=32000)
    k = jax.random.PRNGKey(0)
    trunk_vars = net.init({"params": k, "dropout": k, "specaugment": k},
                          jnp.zeros((1, 32000), jnp.float32), False)
    jnet = jemb.make_embedding_classifier("panns", 5, SR, embed_variables=trunk_vars)
    x = _audio()
    head_vars = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    head, trunk = embedding_classifier_state_dicts(_np_tree(head_vars),
                                                   _np_tree(trunk_vars))
    tnet = temb.make_embedding_classifier("panns", 5, SR, embed_state_dict=trunk,
                                          device="cpu")
    tnet.load_state_dict(head, strict=True)
    return jnet, head_vars, tnet, x


def _stub(x):
    return x[:, :8]


def test_stub_embedding_classifier_matches_jax():
    x = _audio(rows=3, T=64)[:, 0]
    jnet = jemb.EmbeddingClassifier(num_classes=5, sample_rate=16000, embed_fn=_stub,
                                    embed_rate=16000)
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jnet.apply(v, jnp.asarray(x)))
    tnet = temb.EmbeddingClassifier(5, 16000, _stub, embed_dim=8, embed_rate=16000)
    head, trunk = embedding_classifier_state_dicts(_np_tree(v))
    assert trunk is None
    tnet.load_state_dict(head, strict=True)
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 5)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_embedding_classifier_mono_sums_stereo():
    """As tests/test_models.py's: (B, C, T) input mono-sums, it does not
    concatenate channels in time."""
    net = temb.EmbeddingClassifier(5, 16000, _stub, embed_dim=8, embed_rate=16000)
    stereo = torch.stack([torch.ones(2, 64), -0.5 * torch.ones(2, 64)], dim=1)
    torch.testing.assert_close(net(stereo), net(stereo.sum(dim=1)), rtol=0, atol=1e-6)


def test_panns_classifier_carried_across_gives_jax_logits(panns):
    jnet, head_vars, tnet, x = panns
    want = np.asarray(jnet.apply(head_vars, jnp.asarray(x), False))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 5) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["vggish", "wav2clip", "wav2vec2"])
def test_external_kinds_raise(kind):
    with pytest.raises(RuntimeError, match="external HEAR"):
        temb.make_embedding_classifier(kind, 5, SR, device="cpu")
    cfg = tcore.parse_cli(["+exp=5-5_full_cls", f"model=cls_{kind}", "accelerator=cpu"])
    with pytest.raises(RuntimeError, match="external HEAR"):
        build_task(cfg)
    assert temb.EMBED_DIMS[kind] == jemb.EMBED_DIMS[kind]
    assert temb.EMBED_RATES[kind] == jemb.EMBED_RATES[kind]


def test_cls_panns_pt_step_matches_jax(panns):
    jnet, head_vars, tnet, x = panns
    labels = np.array([[1, 0, 0, 1, 0], [0, 0, 1, 0, 0]], np.float32)
    cfg = tcore.parse_cli(["+exp=5-5_full_cls", "model=cls_panns_pt", "accelerator=cpu"])
    m = cfg["model"]
    kw = dict(lr=m["lr"], lr_weight_decay=m["lr_weight_decay"], sample_rate=SR,
              loss_type=m["loss_type"], label_smoothing=m.get("label_smoothing", 0.0),
              gradient_clip_val=cfg["trainer"]["gradient_clip_val"])
    assert kw["loss_type"] == "ce" and kw["lr"] == LR
    jtask = jtasks.ClassifierTask(jnet, **kw)
    jstate = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(x))
    jstate = jstate.replace(params=head_vars["params"])
    jstate = jstate.replace(opt_state=jtask.tx.init(jstate.params))
    jstate, jm = jtask.train_step(jstate, (jnp.asarray(x), jnp.asarray(labels)),
                                  jax.random.PRNGKey(2))
    task = ttasks.ClassifierTask(tnet, **kw)
    state = task.init_state()
    state, m = task.train_step(state, (torch.from_numpy(x), torch.from_numpy(labels)))
    want, got = float(jm["train_loss"]), float(m["train_loss"])
    assert abs(got - want) <= 1e-5 * abs(want)
    head, _ = embedding_classifier_state_dicts(_np_tree({"params": jstate.params}))
    sd = tnet.state_dict()
    for k, v in head.items():
        assert (sd[k] - v).abs().max().item() <= 0.1 * LR, k


def test_cls_panns_pt_trains_with_a_frozen_trunk_and_saves_the_head(tmp_path):
    cfg = tcore.parse_cli(
        ["+exp=5-5_full_cls", "model=cls_panns_pt", "accelerator=cpu",
         "datamodule.synthetic=true", "datamodule.dataset_type=dynamic",
         "datamodule.train_chunks=4", "datamodule.val_chunks=2",
         "datamodule.test_chunks=2", "datamodule.train_batch_size=2",
         "datamodule.test_batch_size=2", "trainer.max_steps=2", "chunk_size=8192",
         "effects_to_remove=[distortion]", "num_removed_effects=[0,1]",
         f"logs_dir={tmp_path}", f"render_root={tmp_path / 'data'}"])
    before = {k: v.clone() for k, v in build_task(cfg).network.state_dict().items()}
    state, metrics = fit(cfg)
    assert np.isfinite(metrics["test_loss"]) and "test_avg_acc" in metrics
    net = state.model
    assert isinstance(net, temb.EmbeddingClassifier)
    # the trainable parameters and the optimizer's state are the head's
    assert sorted(net.state_dict()) == sorted(before) and all(
        k.startswith("proj.") for k in before)
    assert sum(p.numel() for p in net.parameters()) == 2048 * 256 + 256 * 256 + 256 * 5 + 256 + 256 + 5
    assert any(not torch.equal(net.state_dict()[k], v) for k, v in before.items())
    # the trunk: in eval mode, no gradients, bit for bit the seeded one
    trunk = net.embed_fn.trunk
    fresh = temb.make_panns_embed_fn(device="cpu").trunk
    assert not trunk.training and not any(p.requires_grad for p in trunk.parameters())
    for (k, v), (_, w) in zip(trunk.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(v, w), k
    # the checkpoints hold the head only
    for name in ("best", "last"):
        saved = read_state(str(next(tmp_path.rglob(name))), device="cpu")
        assert sorted(saved["model"]) == sorted(before), name
