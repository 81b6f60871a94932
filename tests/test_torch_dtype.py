"""bf16 inference of the port against the JAX package's bf16 contract
(``tests/test_dtype.py``): ``sample(bf16) -> bf16`` for the five removal
backbones (and UMX with its Wiener EM),
Cnn14's probabilities in bf16 with the identity and the resample front
end, and the bf16 chain.

Both sides start from one JAX init at the configurations of
``tests/test_dtype.py`` (the weights carried by ``compat/from_jax.py``);
every fp32 leaf is cast to bf16 (``module.to(torch.bfloat16)`` here,
``_cast_bf16`` there), and both take the same numpy input from a seed,
rounded to bf16. The fp32 runs take that same rounded input, so the bf16
error is the compute's alone. Cnn14 is compared on its 2048-d embedding
(``embed``): at this init its probabilities all lie within a bf16 ulp of
0.5. Per case:

* ``sample`` (Cnn14: the probabilities) is bf16. The JAX package's UMX
  with ``niter=1`` returns fp32 (its EM promotes); the port's returns
  bf16, its EM run in complex64 on the bf16 pair and rounded back.
* The port's bf16 output against the JAX package's bf16 output, max abs
  within ``TOL[case]`` x the RMS of the JAX fp32 output. Measured: tcn
  0.0, demucs 0.127, dcunet 0.025, umx 0.048,
  umx_em 0.045, dptnet 0.081, cnn14_48k 0.027, cnn14_32k 0.030.
* No worse than the reference: the port's bf16 error against the port's
  fp32 output (max abs) is at most twice the JAX package's against its
  own fp32 output, plus one bf16 ulp of that RMS. Measured, port / JAX,
  in units of the RMS: tcn 0.044 / 0.044, demucs 0.088 / 0.098, dcunet
  0.042 / 0.042, umx 0.027 / 0.043, umx_em
  0.054 / 0.048, dptnet 0.121 / 0.100, cnn14_48k 0.028 / 0.029,
  cnn14_32k 0.032 / 0.030. The port's FFTs and UMX's EM run in fp32
  where the JAX package's DFT matmuls and EM run in bf16, so its error
  is the smaller one where those dominate (HDemucs, UMX).
* A forward pre-hook on every ``nn.Conv*``, ``nn.ConvTranspose*``,
  ``nn.Linear``, ``nn.LSTM`` and ``nn.MultiheadAttention``, and a torch
  function mode on the functional convolutions, ``F.linear`` and the
  matmuls (the DCUNet calls ``F.conv2d`` on its modules' weights), find
  only bf16 inputs: no layer is promoted silently.

Every bf16 convolution here runs under the port's own guard
(``utils/device.py:cpu_bf16_convolutions``, entered by ``sample``, the
classifiers and the chain): the oneDNN of torch 2.13.0+cpu computes some
wrong on a CPU with AMX.

The chain: five small TCNs (``tests/test_dtype.py``'s) on 8 rows in bf16,
regroup against single within the JAX package's own 2e-2 absolute; the
port's bf16 chain against the JAX package's within 2e-2 of the RMS
(measured 0.0), its loss and ``test_step``'s metrics within 2^-8
relative. bench.py's composition at a small width, bf16 against fp32,
within the bound ``chip_smoke.py`` holds the full width to, and above it
with a stage skipped; in the slow tier, the smoke's full width on the CPU.

fp32 and fp64 ``stft_ri`` / ``istft_ri`` are ``torch.stft`` /
``torch.istft`` bit for bit, as before the bf16 path was added.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.models import make_cnn14 as jax_make_cnn14
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.ops.mel import MelSpectrogram as JaxMel
from remfx_tpu.ops.resample import resample as jax_resample
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.compat import from_jax
from remfx_tpu_torch.models import make_cnn14, make_model
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.ops.mel import MelSpectrogram
from remfx_tpu_torch.ops.resample import resample
from remfx_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri

torch.set_num_threads(2)
SR = 48000
T = 8192
BF16 = torch.bfloat16

BACKBONES = {  # tests/test_dtype.py's
    "tcn": ("tcn", dict(nblocks=3, channel_width=8, kernel_size=3,
                        dilation_growth=2)),
    "demucs": ("demucs", dict(sources=["mixture"], audio_channels=1, nfft=4096,
                              channels=4, depth=6)),
    "dcunet": ("dcunet", dict(architecture="Mini-DCUNet-6", stft_kernel_size=64,
                              fix_length_mode="pad")),
    "umx": ("umx", dict(n_fft=512, hop_length=256, n_channels=1, hidden_size=32)),
    "umx_em": ("umx", dict(n_fft=512, hop_length=256, n_channels=1, hidden_size=32,
                           niter=1)),
    "dptnet": ("dptnet", dict(n_src=1, in_chan=16, out_chan=16, chunk_size=20,
                              n_repeats=1, fb_name="free", kernel_size=16,
                              n_filters=16, stride=8)),
}
CNN14 = {"cnn14_48k": SR, "cnn14_32k": 32000}
CNN14_NET = dict(num_classes=5, sample_rate=SR, n_fft=512, hop_length=256, n_mels=32)
BRIDGES = {"tcn": from_jax.tcn_state_dict, "demucs": from_jax.demucs_state_dict,
           "dcunet": from_jax.dcunet_state_dict, "umx": from_jax.umx_state_dict,
           "dptnet": from_jax.dptnet_state_dict}
LAYERS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear,
          nn.LSTM, nn.MultiheadAttention)
CONVOLUTIONS = {F.conv1d, F.conv2d, F.conv_transpose1d, F.conv_transpose2d}
FUNCTIONS = CONVOLUTIONS | {F.linear, torch.matmul, torch.bmm, torch.Tensor.matmul,
                            torch.Tensor.__matmul__}
CASES = sorted(BACKBONES) + sorted(CNN14)
TOL = {"tcn": 0.015, "demucs": 0.25, "dcunet": 0.06,
       "umx": 0.1, "umx_em": 0.1, "dptnet": 0.16, "cnn14_48k": 0.06,
       "cnn14_32k": 0.06}
CHAIN_TOL = 0.02  # x the JAX fp32 chain's RMS (measured 0.0)


def _cast_bf16(variables):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
                        variables)


def _input(rows=2, seed=0):
    """A seeded numpy batch rounded to bf16 (held as fp32)."""
    x = np.random.default_rng(seed).standard_normal((rows, 1, T)).astype(np.float32)
    return torch.from_numpy(0.1 * x).to(BF16).float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(np.float64)


def _pair(case):
    """(JAX forward fn, fp32 variables, the port module with the same
    weights) of one case."""
    x1 = jnp.zeros((1, 1, T))
    if case in CNN14:
        net = jax_make_cnn14(model_sample_rate=CNN14[case], **CNN14_NET)
        variables = jax.device_get(net.init({"params": jax.random.PRNGKey(1)}, x1, False))
        port = make_cnn14(model_sample_rate=CNN14[case], device="cpu", **CNN14_NET)
        port.load_state_dict(from_jax.cnn14_state_dict(variables), strict=True)
        return (lambda v, x: net.apply(v, x, False, method=net.embed)), variables, port.eval()
    name, cfg = BACKBONES[case]
    w = jax_make_model(name, **cfg)
    variables = jax.device_get(w.init(jax.random.PRNGKey(0), x1))
    port = make_model(name, device="cpu", **cfg)
    port.module.load_state_dict(BRIDGES[name](variables), strict=True)
    return w.sample, variables, port


class _Inputs(TorchFunctionMode):
    """Records the dtypes of the floating inputs of ``FUNCTIONS``."""

    def __init__(self, seen: set):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in FUNCTIONS:
            self.seen.update((func.__name__, a.dtype) for a in (*args, *kwargs.values())
                             if isinstance(a, torch.Tensor) and a.is_floating_point())
        return func(*args, **kwargs)


def _run_port(module, x: torch.Tensor):
    """The port's output (Cnn14: the embedding and the probabilities), and
    the dtypes that its layers and functional calls saw."""
    seen = set()

    def hook(layer, args):
        seen.update((type(layer).__name__, a.dtype) for a in args
                    if isinstance(a, torch.Tensor))

    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, LAYERS)]
    try:
        with torch.no_grad(), _Inputs(seen):
            if hasattr(module, "sample"):
                out = probs = module.sample(x)
            else:
                out, probs = module.embed(x), module(x)
    finally:
        for h in handles:
            h.remove()
    return out, probs.dtype, seen


@pytest.fixture(scope="module", params=CASES)
def outputs(request):
    """Each side in fp32 and in bf16 from the same weights and input."""
    case = request.param
    fn, variables, port = _pair(case)
    x = _input()
    jfn = jax.jit(fn)
    jax_f32 = _f32(jfn(variables, jnp.asarray(x)))
    jax_bf16 = _f32(jfn(_cast_bf16(variables), jnp.asarray(x, jnp.bfloat16)))
    port_f32, _, _ = _run_port(port, torch.from_numpy(x))
    port_bf16, dtype, seen = _run_port(port.to(BF16), torch.from_numpy(x).to(BF16))
    return {"case": case, "rms": _rms(jax_f32), "jax_f32": jax_f32, "jax_bf16": jax_bf16,
            "port_f32": port_f32.double().numpy(), "port_bf16": port_bf16.double().numpy(),
            "dtype": dtype, "seen": seen}


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def _ulp_bf16(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def test_sample_preserves_bf16(outputs):
    assert outputs["dtype"] == BF16
    assert outputs["port_bf16"].shape == outputs["jax_bf16"].shape
    assert np.isfinite(outputs["port_bf16"]).all()


def test_no_layer_sees_fp32(outputs):
    seen = outputs["seen"]
    assert seen and {dtype for _, dtype in seen} == {BF16}, sorted(map(str, seen))


def test_bf16_matches_jax_bf16(outputs):
    err = np.abs(outputs["port_bf16"] - outputs["jax_bf16"]).max()
    assert err <= TOL[outputs["case"]] * outputs["rms"]


def test_bf16_error_no_worse_than_jax(outputs):
    o = outputs
    port = np.abs(o["port_bf16"] - o["port_f32"]).max()
    ref = np.abs(o["jax_bf16"] - o["jax_f32"]).max()
    assert port <= 2 * ref + _ulp_bf16(o["rms"]), (port, ref)


# ------------------------------------------------------------------ the chain

@pytest.fixture(scope="module")
def chains():
    """tests/test_dtype.py's chain: a small TCN in each of the five slots,
    from one JAX init each, cast to bf16 on both sides; 8 rows, labels from
    a seed."""
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(0)
    x = _input(rows=8, seed=1)
    net = dict(nblocks=2, channel_width=4, kernel_size=3, dilation_growth=2)
    jmodels, models = {}, {}
    for i, name in enumerate(DEFAULT_ORDER):
        w = jax_make_model("tcn", **net)
        variables = jax.device_get(w.init(jax.random.fold_in(key, i), jnp.asarray(x[:1])))
        jmodels[name] = (w, _cast_bf16(variables))
        port = make_model("tcn", device="cpu", **net)
        port.module.load_state_dict(from_jax.tcn_state_dict(variables), strict=True)
        models[name] = port.to(BF16)
    labels = rng.integers(0, 2, (8, 5)).astype(np.float32)
    return jmodels, models, x, labels


def test_bf16_chain_regroup_matches_single(chains):
    _, models, x, labels = chains
    xb, lt = torch.from_numpy(x).to(BF16), torch.from_numpy(labels)
    out = {}
    for mode in ("single", "regroup"):
        loss, out[mode] = ChainInference(models, SR, dispatch=mode).forward((xb, xb, None, lt))
        assert out[mode].dtype == BF16 and loss.dtype == torch.float32
    np.testing.assert_allclose(out["regroup"].float().numpy(), out["single"].float().numpy(),
                               atol=2e-2, rtol=0)


def test_bf16_chain_matches_jax(chains):
    """The port's bf16 chain, its loss and ``test_step`` against the JAX
    package's, single dispatch, the dry target the bf16 input itself."""
    jmodels, models, x, labels = chains
    xj = jnp.asarray(x, jnp.bfloat16)
    jchain = JaxChain(jmodels, SR, dispatch="single")
    jloss, jout = jchain.forward((xj, xj, None, jnp.asarray(labels)))
    jm = jchain.test_step((xj, xj, None, jnp.asarray(labels)))
    xb, lt = torch.from_numpy(x).to(BF16), torch.from_numpy(labels)
    chain = ChainInference(models, SR)
    loss, out = chain.forward((xb, xb, None, lt))
    m = chain.test_step((xb, xb, None, lt))
    assert out.dtype == BF16 and out.shape == tuple(jout.shape)
    want = _f32(jout)
    assert np.abs(out.double().numpy() - want).max() <= CHAIN_TOL * _rms(want)
    assert abs(float(loss) - float(jloss)) <= 2.0 ** -8 * abs(float(jloss))
    assert set(m) == set(jm)
    for k in jm:  # SI-SDR of bf16 pairs is a bf16 value on both sides
        assert abs(float(m[k]) - float(jm[k])) <= 2.0 ** -8 * max(abs(float(jm[k])), 1.0), k


def test_bf16_classifier_labels_are_fp32():
    """``detect`` thresholds bf16 probabilities into fp32 labels, as the
    JAX package's ``threshold_detect`` does."""
    _, _, cls = _pair("cnn14_48k")
    cls = cls.to(BF16)
    x = torch.from_numpy(_input()).to(BF16)
    labels = ChainInference({}, SR, classifier=cls).detect(x)
    with torch.no_grad():
        probs = cls(x)
    assert probs.dtype == BF16 and labels.dtype == torch.float32
    assert torch.equal(labels, (probs > 0.5).float())


def _bench_chain_readings(models: dict, x: torch.Tensor, labels: torch.Tensor):
    """bench.py's chain in bf16 against fp32 from the same weights, max abs
    over the fp32 RMS: (the sound reading, the readings with each of
    ``chip_smoke.BF16_SKIPPED``'s stages skipped), as the smoke's bf16
    phase reads them on the card."""
    import chip_smoke

    half = {k: copy.deepcopy(w).to(BF16) for k, w in models.items()}
    want, _ = ChainInference(models, SR, dispatch="regroup").run(x.float(), labels)
    got, _ = ChainInference(half, SR, dispatch="regroup").run(x, labels)
    assert got.dtype == BF16
    skipped = []
    for effect in chip_smoke.BF16_SKIPPED:
        cut = labels.clone()
        cut[:, ALL_EFFECTS.index(effect)] = 0
        y, _ = ChainInference(half, SR, dispatch="regroup").run(x, cut)
        skipped.append(chip_smoke.max_rel_rms(y, want))
    return chip_smoke.max_rel_rms(got, want), skipped


def test_bench_chain_bf16_within_the_smoke_bound():
    """``chip_smoke.py``'s bf16 phase at a small width: bench.py's
    composition (HDemucs in the distortion and compressor slots, in the
    residual wrapper; Large-DCUNet-20 with identity_init in the other
    three), torch's seeded init, 8 rows of 8192 samples, regroup, labels
    on with p = 0.5 and then all on. The bf16 chain against the fp32 chain
    from the same weights, max abs over the fp32 RMS, is within the bound
    that the smoke holds the full width to on the card (measured 0.037 and
    0.044), and above it with the reverb's or the compressor's stage
    skipped (measured 3.17 and 0.59; 0.80 and 0.68)."""
    import chip_smoke

    torch.manual_seed(0)
    demucs = dict(sources=["mixture"], audio_channels=1, nfft=4096, channels=4, depth=6)
    models = {name: ModelWrapper(make_model("demucs", device="cpu", **demucs).module,
                                 residual=True) if kind == "demucs"
              else make_model("dcunet", device="cpu", **chip_smoke.DCUNET)
              for name, kind in chip_smoke.BENCH_KINDS.items()}
    gen = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(8, 1, T, generator=gen)).to(BF16)
    oracle = (torch.rand(8, 5, generator=gen) < chip_smoke.BF16_P).float()
    for labels in (oracle, torch.ones(8, 5)):
        err, skipped = _bench_chain_readings(models, x, labels)
        assert err <= chip_smoke.BF16_CHAIN_TOL < min(skipped)


@pytest.mark.slow
def test_full_width_bench_chain_bf16_on_the_cpu():
    """The smoke's bf16 checks at its full width on the CPU: its seeded
    ``bench_slots`` (Cnn14, HDemucs at channels 48, Large-DCUNet-20), the
    first two demo clips, every label on. The chain on their first 65536
    samples within ``BF16_CHAIN_TOL`` of fp32 and above it with a stage
    skipped; Cnn14's embedding of the whole clips within
    ``CNN14_BF16_TOL``. Measured: the chain 0.117, skipped 12.3 and 1.28,
    the embedding 0.0079. The card reads 0.114, 14.3, 2.64 and 0.0088 at
    32 rows (PERF.md), so the gap to the small width's chain is width and
    depth, not the card."""
    import chip_smoke

    torch.manual_seed(0)
    cls, slots = chip_smoke.bench_slots(torch.device("cpu"))
    clips = torch.from_numpy(chip_smoke.demo_clips()[:2])[:, None]
    err, skipped = _bench_chain_readings(slots, clips[..., :65536].to(BF16),
                                         torch.ones(2, len(ALL_EFFECTS)))
    with torch.no_grad():
        embed = chip_smoke.max_rel_rms(copy.deepcopy(cls).to(BF16).embed(clips.to(BF16)),
                                       cls.embed(clips))
    assert err <= chip_smoke.BF16_CHAIN_TOL < min(skipped)
    assert embed <= chip_smoke.CNN14_BF16_TOL


# ------------------------------------------------------------------ the ops

def test_bf16_resample_and_mel_match_jax():
    """Cnn14's front-end ops on a bf16 signal: the resampler (48 -> 32 kHz)
    and the mel spectrogram stay bf16, against the JAX package's bf16."""
    x = _input()[:, 0]
    got = resample(torch.from_numpy(x).to(BF16), SR, 32000)
    want = _f32(jax_resample(jnp.asarray(x, jnp.bfloat16), SR, 32000))
    assert got.dtype == BF16 and got.shape == want.shape
    assert np.abs(got.double().numpy() - want).max() <= 2.0 ** -8 * _rms(want)  # measured 0
    mel = MelSpectrogram(32000, 512, 256, 32).to(BF16)(got)
    jmel = _f32(JaxMel(32000, 512, 256, 32)(jnp.asarray(got.float().numpy(), jnp.bfloat16)))
    assert mel.dtype == BF16 and mel.shape == jmel.shape
    # measured 0.021: the port's FFT in fp32, the JAX package's DFT in bf16
    assert np.abs(mel.double().numpy() - jmel).max() <= 0.05 * _rms(jmel)


# ------------------------------------------------------------------ the STFT

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_full_precision_stft_is_torch_stft(dtype):
    """fp32 and fp64 go through ``torch.stft`` / ``torch.istft`` as they
    come: bit for bit the calls before the bf16 path was added."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 2048))).to(dtype)
    window = hann_window(512, dtype=dtype)
    re, im = stft_ri(x, 512, 128, window)
    z = torch.stft(x.reshape(-1, 2048), 512, 128, win_length=512, window=window,
                   center=True, pad_mode="reflect", return_complex=True)
    assert re.dtype == im.dtype == dtype
    assert torch.equal(re, z.real.reshape(2, 3, *z.shape[-2:]))
    assert torch.equal(im, z.imag.reshape(2, 3, *z.shape[-2:]))
    y = istft_ri(re, im, 512, 128, window, length=2048)
    zi = z.clone()
    zi.imag[:, 0] = 0
    zi.imag[:, -1] = 0
    want = torch.istft(zi, 512, 128, win_length=512, window=window, center=True)
    assert y.dtype == dtype and torch.equal(y, want[..., :2048].reshape(2, 3, 2048))


def test_bf16_stft_rounds_the_fp32_transform():
    """A bf16 signal: the fp32 transform of its values, with the window in
    fp32 whatever its buffer's dtype, rounded to bf16 once."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 2048))).to(BF16)
    window = hann_window(512)
    re, im = stft_ri(x, 512, 128, window.to(BF16))
    want_re, want_im = stft_ri(x.float(), 512, 128, window.to(BF16).float())
    assert re.dtype == im.dtype == BF16
    assert torch.equal(re, want_re.to(BF16)) and torch.equal(im, want_im.to(BF16))
    y = istft_ri(re, im, 512, 128, window, length=2048)
    assert y.dtype == BF16
    assert torch.equal(y, istft_ri(re.float(), im.float(), 512, 128, window,
                                   length=2048).to(BF16))
