"""DCUNet of the port (``remfx_tpu_torch/models/dcunet.py``) against the
JAX package, piece by piece and whole, with ``dcunet_state_dict``.

Mini-DCUNet-6 runs at stft kernel 64 (F = 33) on 4000 samples (124
frames, padded to 125); Large-DCUNet-20 at kernel 512 on 8192 samples
(31 frames, no pad). Running statistics are drawn away from their
initial values so that eval-mode norms are held to non-trivial numbers.

Tolerances: filters 1e-7 absolute (both round the same float64 values
once); the STFT pair, convs and norms 1e-5 of the output's peak; whole
models 1e-4 x the RMS of the JAX output (fp32, another summation order
through up to 20 complex layers); the oracle of ``tests/_torch_dcunet.py``
1e-5 x RMS (same framework, same algorithms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.models import dcunet as jd
from remfx_tpu_torch.compat.from_jax import dcunet_state_dict
from remfx_tpu_torch.models import dcunet as td
from remfx_tpu_torch.models import make_dcunet
from tests._torch_dcunet import TorchDCUNet

torch.set_num_threads(2)
TOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _peak_err(got, want):
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _rms_err(got, want):
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.sqrt(np.mean(want ** 2))


def _perturb_stats(variables, seed=3):
    """Running statistics away from (0, 1): means ±0.2, variances 0.5-2,
    complex covariances positive definite."""
    rng = _rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k in ("mean", "running_mean"):
                out[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "running_covar":
                c = v.shape[0]
                vrr, vii = rng.uniform(0.5, 2.0, (2, c))
                vri = rng.uniform(-0.3, 0.3, c) * np.sqrt(vrr * vii)
                out[k] = np.stack([vrr, vri, vii], 1).astype(np.float32)
            else:
                out[k] = v
        return out

    return dict(variables, batch_stats=walk(variables["batch_stats"]))


# ---------------------------------------------------------------- front end

@pytest.mark.parametrize("K,n", [(64, None), (512, None), (64, 128)])
def test_stft_filters_match_jax(K, n):
    want = jd._stft_filters(K, n)
    got = td._stft_filters(K, n)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-7


@pytest.mark.parametrize("K,T", [(64, 4000), (512, 8192)])
def test_asteroid_stft_matches_jax(K, T):
    x = (0.3 * _rng(0).standard_normal((2, T))).astype(np.float32)
    wr, wi = (np.asarray(a) for a in jd.asteroid_stft(jnp.asarray(x), K))
    gr, gi = (a.numpy() for a in td.asteroid_stft(torch.from_numpy(x), K))
    assert _peak_err(gr, wr) <= 1e-5 and _peak_err(gi, wi) <= 1e-5


# length below, at and past the overlap-add's K + (K/2)(N-1) = 4000 samples
@pytest.mark.parametrize("length", [3900, 4000, 4100])
def test_asteroid_istft_matches_jax(length):
    K, N = 64, 124
    rng = _rng(1)
    re, im = rng.standard_normal((2, 2, K // 2 + 1, N)).astype(np.float32)
    want = np.asarray(jd.asteroid_istft(jnp.asarray(re), jnp.asarray(im), K, length))
    got = td.asteroid_istft(torch.from_numpy(re), torch.from_numpy(im), K, length).numpy()
    assert got.shape == (2, length)
    assert _peak_err(got, want) <= 1e-5
    if length > 4000:
        assert not got[:, 4000:].any()


# ---------------------------------------------------------------- layers

CONV_CASES = [
    # (kernel, stride, transpose, use_bias)
    ((3, 3), (1, 1), False, False),
    ((7, 5), (2, 2), False, False),
    ((5, 3), (2, 1), False, True),
    ((7, 5), (2, 1), True, False),
    ((5, 3), (2, 2), True, True),
    ((1, 7), (1, 1), True, False),
]


@pytest.mark.parametrize("gauss", [False, True], ids=["stacked", "gauss"])
@pytest.mark.parametrize("kernel,stride,transpose,use_bias", CONV_CASES)
def test_complex_conv_matches_jax(kernel, stride, transpose, use_bias, gauss):
    cin, cout, H, W = 3, 4, 17, 9
    rng = _rng(2)
    xr, xi = rng.standard_normal((2, 2, H, W, cin)).astype(np.float32)  # NHWC
    jm = jd.ComplexConv(cout, kernel, stride, transpose=transpose,
                        use_bias=use_bias, gauss=gauss)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(xr), jnp.asarray(xi)))
    p = v["params"]
    if use_bias:
        p["re_bias"], p["im_bias"] = rng.standard_normal((2, cout)).astype(np.float32)
    wr, wi = (np.asarray(a) for a in jm.apply(v, jnp.asarray(xr), jnp.asarray(xi)))
    port = td.ComplexConv(cin, cout, kernel, stride, transpose=transpose,
                          use_bias=use_bias, gauss=gauss)
    perm = (2, 3, 0, 1) if transpose else (3, 2, 0, 1)
    sd = {f"{part}_module.weight": torch.from_numpy(
        np.asarray(p[f"{part}_kernel"]).transpose(perm).copy()) for part in ("re", "im")}
    if use_bias:
        sd.update({f"{part}_module.bias": torch.from_numpy(p[f"{part}_bias"])
                   for part in ("re", "im")})
    port.load_state_dict(sd, strict=True)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    with torch.no_grad():
        gr, gi = (a.numpy().transpose(0, 2, 3, 1) for a in port(nchw(xr), nchw(xi)))
    assert _peak_err(gr, wr) <= 1e-5 and _peak_err(gi, wi) <= 1e-5


def _norm_pair(kind, C=6):
    rng = _rng(4)
    xr, xi = (rng.standard_normal((2, 2, 5, 7, C)) * 0.7 + 0.1).astype(np.float32)
    jm = jd.ComplexBatchNorm() if kind == "CbN" else jd.OnReImBatchNorm()
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(xr),
                               jnp.asarray(xi), False))
    v = _perturb_stats(v)
    port = td.ComplexBatchNorm(C) if kind == "CbN" else td.OnReImBatchNorm(C)
    sd = dcunet_state_dict({"params": {"enc0_norm": v["params"]},
                            "batch_stats": {"enc0_norm": v["batch_stats"]}})
    port.load_state_dict({k.split("norm.", 1)[1]: t for k, t in sd.items()},
                         strict=True)
    return jm, v, port, xr, xi


@pytest.mark.parametrize("kind", ["bN", "CbN"])
def test_norm_eval_matches_jax(kind):
    jm, v, port, xr, xi = _norm_pair(kind)
    wr, wi = (np.asarray(a) for a in jm.apply(v, jnp.asarray(xr), jnp.asarray(xi), False))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    with torch.no_grad():
        gr, gi = (a.numpy().transpose(0, 2, 3, 1)
                  for a in port.eval()(nchw(xr), nchw(xi)))
    assert _peak_err(gr, wr) <= 1e-5 and _peak_err(gi, wi) <= 1e-5


def test_complex_batchnorm_train_matches_jax():
    """The train branch: whitening by the batch's covariance, and the
    running statistics' update."""
    jm, v, port, xr, xi = _norm_pair("CbN")
    (wr, wi), upd = jm.apply(v, jnp.asarray(xr), jnp.asarray(xi), True,
                             mutable=["batch_stats"])
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    with torch.no_grad():
        gr, gi = (a.numpy().transpose(0, 2, 3, 1)
                  for a in port.train()(nchw(xr), nchw(xi)))
    assert _peak_err(gr, np.asarray(wr)) <= 1e-5
    assert _peak_err(gi, np.asarray(wi)) <= 1e-5
    for name in ("running_mean", "running_covar"):
        want = np.asarray(upd["batch_stats"][name])
        assert np.abs(getattr(port, name).numpy() - want).max() <= 1e-6


def test_decoder_args_match_jax():
    for stages in (jd.LARGE_DCUNET_20, jd.MINI_DCUNET_6):
        assert td._decoder_args(stages) == jd._decoder_args(stages)
    assert td.LARGE_DCUNET_20 == jd.LARGE_DCUNET_20
    assert td.MINI_DCUNET_6 == jd.MINI_DCUNET_6


# ---------------------------------------------------------------- whole

def _model_pair(arch, K, T, identity_init, norm_type="bN", seed=0):
    kw = dict(architecture=arch, stft_kernel_size=K, identity_init=identity_init,
              norm_type=norm_type)
    jm = jd.DCUNet(**kw)
    v = jax.device_get(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(seed), jnp.zeros((2, 1, T)), False))
    v = _perturb_stats(v, seed + 3)
    if identity_init:
        v["params"]["mask_bias"] = np.array([1.2, -0.3], np.float32)
    port = make_dcunet(device="cpu", **kw)
    port.module.load_state_dict(dcunet_state_dict(v), strict=True)
    return jm, v, port


def _audio(T, seed=5):
    x = _rng(seed).standard_normal((2, 1, T)).astype(np.float32)
    return (0.3 * x * np.linspace(0.2, 1.0, T, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("identity_init,norm_type", [
    (False, "bN"), (True, "bN"), (False, "CbN")])
def test_mini_dcunet_matches_jax(identity_init, norm_type):
    T = 4000
    jm, v, port = _model_pair("Mini-DCUNet-6", 64, T, identity_init, norm_type)
    x = _audio(T)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(v, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1, T)
    assert _rms_err(got, want) <= TOL


def test_large_dcunet_matches_jax():
    T = 8192
    jm, v, port = _model_pair("Large-DCUNet-20", 512, T, True)
    x = _audio(T)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(v, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1, T)
    assert _rms_err(got, want) <= TOL
    assert port.output_length(T) == T


def test_gauss_conv_model_matches_stacked():
    """gauss_conv is the same math as the stacked convs."""
    T = 4000
    _, v, port = _model_pair("Mini-DCUNet-6", 64, T, False)
    gauss = make_dcunet(device="cpu", architecture="Mini-DCUNet-6",
                        stft_kernel_size=64, gauss_conv=True)
    gauss.module.load_state_dict(port.module.state_dict(), strict=True)
    x = torch.from_numpy(_audio(T))
    want = port.sample(x).numpy()
    assert _rms_err(gauss.sample(x).numpy(), want) <= TOL


def test_incompatible_frequency_count_raises_type_error():
    # Large's frequency strides multiply to 256; K 256 gives F = 129
    port = td.DCUNet(stft_kernel_size=256).eval()
    x = torch.zeros(1, 1, 4096)
    with pytest.raises(TypeError, match="incompatible"):
        port(x)
    jm = jd.DCUNet(stft_kernel_size=256)
    with pytest.raises(TypeError, match="incompatible"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 4096)))


def test_fix_length_mode_other_than_pad_raises():
    with pytest.raises(ValueError, match="trim"):
        td.DCUNet(architecture="Mini-DCUNet-6", fix_length_mode="trim")
    with pytest.raises(ValueError, match="trim"):
        make_dcunet(device="cpu", architecture="Mini-DCUNet-6",
                    fix_length_mode="trim")


@pytest.mark.parametrize("T", [700, 2048])
def test_port_matches_the_torch_oracle(T):
    """tests/_torch_dcunet.py's asteroid-structure oracle with the port's
    own state dict: the same names and the same forward graph."""
    _, _, port = _model_pair("Mini-DCUNet-6", 64, 4000, False)
    oracle = TorchDCUNet(td.MINI_DCUNET_6, 64, norm_type="bN",
                         filters=td._stft_filters(64).copy())
    sd = dict(port.module.state_dict(), filters=oracle.filters)
    oracle.load_state_dict(sd, strict=True)
    x = _audio(T)[:, 0]
    with torch.no_grad():
        want = oracle.eval()(torch.from_numpy(x)).numpy()
        got = port.module(torch.from_numpy(x)).numpy()
    assert _rms_err(got, want) <= 1e-5
