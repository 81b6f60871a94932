"""TCN of the port (``remfx_tpu_torch/models/tcn.py``) against the JAX
package, with ``center_crop`` and the ``tcn_state_dict`` bridge.

Config: 4 blocks, width 8, kernel 7, dilation growth 2 (receptive field
91) at 4096 samples, causal and non-causal.

Tolerance: 1e-5 absolute on the ``tanh`` output (fp32, another summation
order through 4 dilated convs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import make_tcn as jax_make_tcn
from remfx_tpu.models.tcn import TCN as JaxTCN
from remfx_tpu.utils.crop import center_crop as jax_center_crop
from remfx_tpu_torch.compat.from_jax import tcn_state_dict
from remfx_tpu_torch.models import make_tcn
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.utils.crop import center_crop

torch.set_num_threads(2)
CFG = dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2,
           stack_size=10)
T = 4096
TOL = 1e-5
# ckpts/tcn_distortion_aug/hparams.json's network, as make_tcn reads it
CKPT_CFG = dict(nblocks=10, channel_width=64)


def _audio(seed=0, T=T):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((2, 1, T))).astype(np.float32)


@pytest.mark.parametrize("L,length", [(10, 4), (11, 4), (11, 11), (9, 0)])
def test_center_crop_matches_jax(L, length):
    x = np.arange(2 * L, dtype=np.float32).reshape(2, L)
    want = np.asarray(jax_center_crop(jnp.asarray(x), length))
    got = center_crop(torch.from_numpy(x), length).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=[False, True], ids=["noncausal", "causal"])
def pair(request):
    causal = request.param
    jm = JaxTCN(causal=causal, **CFG)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((2, 1, T))))
    # non-trivial PReLU slopes, so both branches of the where are held
    rng = np.random.default_rng(1)
    for n in range(CFG["nblocks"]):
        variables["params"][f"block{n}"]["relu"]["weight"] = rng.uniform(
            -0.5, 0.8, CFG["channel_width"]).astype(np.float32)
    port = TCN(causal=causal, **CFG)
    port.load_state_dict(tcn_state_dict(variables), strict=True)
    return jm, variables, port.eval()


def test_tcn_matches_jax(pair):
    jm, variables, port = pair
    x = _audio()
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, T - 91 + 1)
    assert np.abs(got - want).max() <= TOL


def test_receptive_field_matches_jax():
    assert TCN(**CFG).compute_receptive_field() == JaxTCN(**CFG).compute_receptive_field() == 91
    jax_ckpt = jax_make_tcn(**CKPT_CFG).module
    port_ckpt = make_tcn(device="cpu", **CKPT_CFG)
    assert port_ckpt.module.compute_receptive_field() == 6139
    assert jax_ckpt.compute_receptive_field() == 6139
    assert port_ckpt.output_length(262144) == 256006


def test_tcn_state_dict_loads_strict_and_rejects_leftovers(pair):
    _, variables, _ = pair
    sd = tcn_state_dict(variables)
    assert set(sd) == set(TCN(**CFG).state_dict())
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros(3)})}
    with pytest.raises(ValueError, match="stray"):
        tcn_state_dict(extra)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_remat_equals_no_remat_bit_for_bit(causal):
    """``remat`` (each block under ``torch.utils.checkpoint`` in train mode)
    recomputes the blocks' activations in the backward pass: the forward
    and every gradient equal the network without it bit for bit, and eval
    mode does not checkpoint."""
    torch.manual_seed(0)
    plain = TCN(causal=causal, **CFG)
    remat = TCN(causal=causal, remat=True, **CFG)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_audio(seed=2))
    outs = []
    for net in (plain, remat):
        xi = x.clone().requires_grad_(True)
        y = net.train()(xi)
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
        outs.append((y.detach(), xi.grad, [p.grad for p in net.parameters()]))
    (y0, gx0, g0), (y1, gx1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert make_tcn(device="cpu", **CFG).module.remat  # the JAX default
    assert not make_tcn(device="cpu", remat=False, **CFG).module.remat
    with torch.no_grad():
        assert torch.equal(remat.eval()(x), plain.eval()(x))
