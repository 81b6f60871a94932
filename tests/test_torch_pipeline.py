"""``PipelineChain`` of the port (``remfx_tpu_torch/chain/pipeline.py``):
one stage per device, against ``ChainInference.run`` and against the JAX
package's ``PipelineChain`` on its virtual CPU devices.

The chain: a full-width Cnn14 classifier (detect mode only), a small TCN
in the distortion slot (4 blocks, width 8, kernel 7) and a Mini-DCUNet-6
in the reverb slot, weights carried from JAX inits; three windows of 2 x
8192. On ``[cpu, cpu]`` (the stages alternate between two CPU devices)
each window equals ``ChainInference.run`` bit for bit, in detect, oracle
and "all" modes. Against JAX: the tolerance of ``tests/test_torch_chain.py``
for ``run``, audio within 1e-4 x the RMS of the JAX output, labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.chain.pipeline import PipelineChain as JaxPipeline
from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models.dcunet import DCUNet as JaxDCUNet
from remfx_tpu.models.tcn import TCN as JaxTCN
from remfx_tpu.models.wrappers import ModelWrapper as JaxWrapper
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.chain.pipeline import PipelineChain
from remfx_tpu_torch.compat.from_jax import cnn14_state_dict, dcunet_state_dict, tcn_state_dict
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.wrappers import ModelWrapper

torch.set_num_threads(2)
SR = 48000
B, T, W = 2, 8192, 3
TOL = 1e-4
TCN_CFG = dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2)
DCUNET_CFG = dict(architecture="Mini-DCUNet-6", stft_kernel_size=64, identity_init=True)
DIST, REVERB = "RandomPedalboardDistortion", "RandomPedalboardReverb"
MODES = ("detect", "oracle", "all")


@pytest.fixture(scope="module")
def models():
    x0 = jnp.zeros((B, 1, T))
    net = jax_make_cnn14()
    cv = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((B, T))))
    cls = make_cnn14(device="cpu")
    cls.load_state_dict(cnn14_state_dict(cv), strict=True)
    jw = JaxWrapper(JaxTCN(**TCN_CFG))
    tv = jax.device_get(jw.init(jax.random.PRNGKey(1), x0))
    tcn = TCN(**TCN_CFG)
    tcn.load_state_dict(tcn_state_dict(tv), strict=True)
    dw = JaxWrapper(JaxDCUNet(**DCUNET_CFG), takes_train_flag=True)
    dv = jax.device_get(dw.init(jax.random.PRNGKey(2), x0))
    dv["params"]["mask_bias"] = np.array([1.3, -0.2], np.float32)
    dcunet = DCUNet(**DCUNET_CFG)
    dcunet.load_state_dict(dcunet_state_dict(dv), strict=True)
    jax_models = {DIST: (jw, tv), REVERB: (dw, dv)}
    port_models = {DIST: ModelWrapper(tcn), REVERB: ModelWrapper(dcunet)}
    return (net, cv), cls, jax_models, port_models


def _windows():
    rng = np.random.default_rng(5)
    return [(0.3 * rng.standard_normal((B, 1, T))).astype(np.float32) for _ in range(W)]


def _labels():
    labels = np.zeros((B, len(ALL_EFFECTS)), np.float32)
    labels[0, ALL_EFFECTS.index("distortion")] = 1.0
    labels[:, ALL_EFFECTS.index("reverb")] = 1.0
    return labels


@pytest.fixture(scope="module", params=MODES)
def runs(request, models):
    """(mode, the port's pipeline and run per window, JAX's pipeline)."""
    mode = request.param
    jcls, cls, jax_models, port_models = models
    kw = {"use_all_effect_models": mode == "all"}
    with_cls = mode == "detect"
    chain = ChainInference(port_models, SR, classifier=cls if with_cls else None, **kw)
    jchain = JaxChain(jax_models, SR, classifier=jcls if with_cls else None,
                      dispatch="staged", **kw)
    labels = _labels() if mode == "oracle" else None
    xs = _windows()
    pipe = PipelineChain(chain, devices=["cpu", "cpu"])
    got = pipe([torch.from_numpy(x) for x in xs],
               None if labels is None else torch.from_numpy(labels))
    want = [chain.run(torch.from_numpy(x),
                      None if labels is None else torch.from_numpy(labels)) for x in xs]
    jpipe = JaxPipeline(jchain, devices=jax.devices()[:2])
    jout = jpipe([jnp.asarray(x) for x in xs], None if labels is None else jnp.asarray(labels))
    return mode, pipe, got, want, jout


def test_pipeline_equals_run_bit_for_bit(runs):
    mode, _, got, want, _ = runs
    assert len(got) == W
    for (y, lab), (y_run, lab_run) in zip(got, want):
        assert torch.equal(lab, lab_run), mode
        assert torch.equal(y, y_run), mode
    if mode == "all":
        assert all(torch.equal(lab, torch.ones(B, len(ALL_EFFECTS))) for _, lab in got)


def test_pipeline_matches_the_jax_pipeline(runs):
    mode, _, got, _, jout = runs
    for (y, lab), (jy, jlab) in zip(got, jout):
        want = np.asarray(jy)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
        assert y.shape == want.shape, mode
        assert np.abs(y.numpy() - want).max() <= TOL * np.sqrt(np.mean(want ** 2)), mode


def test_stages_go_round_robin_classifier_first(runs):
    mode, pipe, _, _, _ = runs
    stages = (["classifier"] if mode == "detect" else []) + [DIST, REVERB]
    assert list(pipe.stage_device) == stages
    assert [d.type for d in pipe.stage_device.values()] == ["cpu"] * len(stages)


def test_pipeline_asks_for_the_card_by_default(models):
    _, _, _, port_models = models
    chain = ChainInference(port_models, SR)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineChain(chain)
