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

Inference (eval mode with autograd off) takes the packed channels-last
path, whose norm, leaky ReLU and skip concatenation are
``ops/dcunet_epilogue.py``; ``sample`` runs it, so the whole-model tests
above hold it to JAX. The tests below hold it to the two-tensor path (an
eval forward under autograd) within 1e-5 x RMS in fp32 (the norm folded
into one affine: another rounding order), the epilogue's plain version to
the composition norm -> leaky ReLU -> cat (fp32 1e-6 of the peak, bf16 one
rounding of 2^-8; the skip bit for bit), and train mode to the two-tensor
modules composed as before, bit for bit.
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
from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue, dcunet_epilogue_plain
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


# ---------------------------------------------------------------- the packed path

def _packed_pair(arch, norm_type, seed=0):
    """A port model with perturbed statistics (no JAX), and its input."""
    K, T = (64, 4000) if arch == "Mini-DCUNet-6" else (512, 8192)
    torch.manual_seed(seed)
    port = make_dcunet(device="cpu", architecture=arch, stft_kernel_size=K,
                       norm_type=norm_type, identity_init=True)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in port.module.named_buffers():
            if name.endswith("running_mean"):
                t.uniform_(-0.2, 0.2, generator=g)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 2.0, generator=g)
            elif name.endswith("running_covar"):
                vrr, vii = torch.rand(2, t.shape[0], generator=g) * 1.5 + 0.5
                vri = (torch.rand(t.shape[0], generator=g) - 0.5) * 0.6 * (vrr * vii).sqrt()
                t.copy_(torch.stack([vrr, vri, vii], 1))
        for name, t in port.module.named_parameters():
            if "norm" in name:
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return port, torch.from_numpy(_audio(T))


ARCH_NORMS = [(a, n) for a in ("Mini-DCUNet-6", "Large-DCUNet-20") for n in ("bN", "CbN")]


@pytest.fixture
def epilogues(monkeypatch):
    """The masker's epilogue calls, counted: on the CPU its plain version
    runs and ``dcunet_epilogue.launches``, the card's count, stays put."""
    calls = []
    real = td.dcunet_epilogue

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(td, "dcunet_epilogue", counted)
    return calls


@pytest.mark.parametrize("arch,norm_type", ARCH_NORMS)
def test_packed_path_matches_the_two_tensor_path(arch, norm_type, epilogues):
    """Inference's packed path against the same eval forward under autograd,
    which takes the two-tensor path: fp32, 1e-5 x RMS."""
    port, x = _packed_pair(arch, norm_type)
    with torch.no_grad():
        packed = port.module(x)
    launches = len(epilogues)
    assert launches > 0
    two = port.module(x).detach()
    assert len(epilogues) == launches
    assert _rms_err(packed.numpy(), two.numpy()) <= 1e-5


@pytest.mark.parametrize("frozen", [True, False])
def test_eval_under_grad_mode_takes_the_packed_path_where_nothing_is_recorded(
        frozen, epilogues):
    """Grad mode alone does not switch the path: with the masker's
    parameters frozen and a plain input, an eval forward runs the packed
    path; an input that requires grad takes the two-tensor path, and its
    gradient flows. Both equal inference's output."""
    port, x = _packed_pair("Mini-DCUNet-6", "bN")
    with torch.no_grad():
        want = port.module(x)
    del epilogues[:]
    port.module.requires_grad_(False)
    if not frozen:
        x = x.clone().requires_grad_()
    got = port.module(x)
    assert len(epilogues) == (7 if frozen else 0)
    assert got.requires_grad != frozen
    if not frozen:
        got.square().sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert _rms_err(got.detach().numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("arch,norm_type", [("Mini-DCUNet-6", "CbN"),
                                            ("Large-DCUNet-20", "CbN")])
def test_packed_path_matches_jax(arch, norm_type, epilogues):
    """The whole-model tests above run the packed path in bN; the complex
    whitening norm here, both architectures."""
    K, T = (64, 4000) if arch == "Mini-DCUNet-6" else (512, 8192)
    jm, v, port = _model_pair(arch, K, T, True, norm_type)
    x = _audio(T)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(v, jnp.asarray(x)))
    got = port.sample(torch.from_numpy(x)).numpy()
    assert len(epilogues) == 2 * len(port.module.stages) - 1
    assert _rms_err(got, want) <= TOL


def _composed(norm, x, C, skip, S):
    """The old composition on (re, im): the norm module, the leaky ReLUs,
    then each half's cat with the skip's half; packed for comparison as
    [re, im, skip re, skip im]."""
    yr, yi = norm(x[:, :C], x[:, C:2 * C])
    yr, yi = torch.nn.functional.leaky_relu(yr, 0.01), torch.nn.functional.leaky_relu(yi, 0.01)
    if skip is None:
        return torch.cat([yr, yi], 1)
    hr, hi = torch.cat([yr, skip[:, :S]], 1), torch.cat([yi, skip[:, S:2 * S]], 1)
    return torch.cat([hr[:, :C], hi[:, :C], hr[:, C:], hi[:, C:]], 1)


@pytest.mark.parametrize("kind", ["bN", "CbN"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,S", [(5, 0), (45, 45), (6, 3)])
def test_epilogue_plain_is_the_norm_relu_cat_composition(kind, dtype, C, S):
    """Packed channels padded to multiples of 8 (x 2C + 4, the skip 2S + 2):
    the norm, leaky ReLU and cat of the first channels, zeros after."""
    torch.manual_seed(7)
    norm = (td.ComplexBatchNorm(C) if kind == "CbN" else td.OnReImBatchNorm(C)).eval()
    with torch.no_grad():
        for t in norm.parameters():
            t.add_(0.2 * torch.randn(t.shape))
        for name, t in norm.named_buffers():
            if "mean" in name:
                t.uniform_(-0.3, 0.3)
            elif "covar" in name:
                t.copy_(torch.tensor([1.3, 0.4, 0.8]).repeat(C, 1))
            elif "var" in name:
                t.uniform_(0.5, 2.0)
    norm = norm.to(dtype)
    x = torch.randn(2, 7, 9, 2 * C + 4).permute(0, 3, 1, 2).to(dtype)  # channels-last
    skip = None if S == 0 else torch.randn(2, 2 * S + 2, 7, 9).to(dtype)
    with torch.no_grad():
        want = _composed(norm, x, C, skip, S)
        full = dcunet_epilogue_plain(x, norm.eval_affine(), skip, 2 * S)
        # bf16: the composition computed in fp32 from the same bf16 values,
        # which the epilogue rounds once (torch's bf16 norm rounds at every step)
        exact = _composed(norm.float(), x.float(), C, None if skip is None else skip.float(), S)
    width = 2 * C + 2 * S
    assert full.shape[1] == -(-width // 8) * 8 and not full[:, width:].any()
    assert full.dtype == dtype and full.is_contiguous(memory_format=torch.channels_last)
    got = full[:, :width]
    assert torch.equal(got[:, 2 * C:], want[:, 2 * C:])
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
    else:
        torch.testing.assert_close(got.float(), exact, rtol=2**-8, atol=1e-6)


def test_kept_weights_follow_load_state_dict_and_training():
    """The packed path's kept block weights and norm coefficients are built
    again after ``load_state_dict``, after a training step (train() then
    eval()) and after a dtype change: each output equals a fresh model's
    with the same state."""
    port, x = _packed_pair("Mini-DCUNet-6", "bN")
    other, _ = _packed_pair("Mini-DCUNet-6", "bN", seed=5)

    def fresh(module):
        new = make_dcunet(device="cpu", architecture="Mini-DCUNet-6", stft_kernel_size=64,
                          identity_init=True).to(next(module.parameters()).dtype)
        new.module.load_state_dict(module.state_dict(), strict=True)
        with torch.no_grad():
            return new.module(x.to(next(module.parameters()).dtype))

    module = port.module
    with torch.no_grad():
        first = module(x)
        assert torch.equal(module(x), first)
    module.load_state_dict(other.module.state_dict())
    with torch.no_grad():
        loaded = module(x)
    assert not torch.equal(loaded, first) and torch.equal(loaded, fresh(module))

    module.train()
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    module(x).square().mean().backward()
    opt.step()
    module.eval()
    with torch.no_grad():
        trained = module(x)
    assert not torch.equal(trained, loaded) and torch.equal(trained, fresh(module))

    module.to(torch.bfloat16)
    with torch.no_grad():
        half = module(x.to(torch.bfloat16))
    assert torch.equal(half, fresh(module))


def _two_tensor_forward(model, x):
    """The DCUNet forward as composed before the packed path: every block on
    (re, im), the skips concatenated per half."""
    m = model.masker
    re, im = td.asteroid_stft(x, model.stft_kernel_size, model.filters)
    F_full, N_in = re.shape[-2:]
    pad_t = (-(N_in - 1)) % model.time_prod
    hr, hi = torch.nn.functional.pad(re, (0, pad_t))[:, None], \
        torch.nn.functional.pad(im, (0, pad_t))[:, None]
    skips = []
    for enc in m.encoders:
        hr, hi = enc(hr, hi)
        skips.append((hr, hi))
    for k, dec in enumerate(m.decoders):
        hr, hi = dec(hr, hi)
        sr, si = skips[len(m.decoders) - 1 - k]
        hr, hi = torch.cat([hr, sr], dim=1), torch.cat([hi, si], dim=1)
    mr, mi = m.output_layer(hr, hi)
    mr, mi = mr[:, 0, :F_full, :N_in], mi[:, 0, :F_full, :N_in]
    if model.identity_init:
        mr, mi = mr + m.mask_bias[0], mi + m.mask_bias[1]
    mag = torch.sqrt(mr * mr + mi * mi + 1e-12)
    scale = torch.tanh(mag) / mag
    mr, mi = mr * scale, mi * scale
    return td.asteroid_istft(mr * re - mi * im, mr * im + mi * re, model.stft_kernel_size,
                             x.shape[-1], model.filters)


@pytest.mark.parametrize("norm_type", ["bN", "CbN"])
def test_train_mode_is_the_two_tensor_path_bit_for_bit(norm_type, epilogues):
    """Train mode: the output, the gradients and the running statistics
    are those of the two-tensor composition, bit for bit, and the epilogue
    never runs."""
    port, x = _packed_pair("Mini-DCUNet-6", norm_type)
    model = port.module.train()
    twin, _ = _packed_pair("Mini-DCUNet-6", norm_type)
    twin = twin.module.train()
    x = x[:, 0]
    got, want = model(x), _two_tensor_forward(twin, x)
    assert not epilogues
    assert torch.equal(got, want)
    got.square().sum().backward()
    want.square().sum().backward()
    for (name, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), b in zip(model.named_buffers(), twin.buffers()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch,launches", [("Mini-DCUNet-6", 7), ("Large-DCUNet-20", 19)])
def test_epilogue_launches_per_forward(arch, launches, epilogues):
    """One epilogue a normed block: 10 encoders and 9 decoders of
    Large-DCUNet-20 in inference; none in train mode. On the CPU the plain
    version runs them, and the kernel's launch count stays put."""
    port, x = _packed_pair(arch, "bN")
    before = dcunet_epilogue.launches
    port.sample(x)
    assert len(epilogues) == launches
    with torch.no_grad():
        port.module.train()(x[:, 0])
    assert len(epilogues) == launches
    assert dcunet_epilogue.launches == before
