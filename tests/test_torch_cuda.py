"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.

Tolerance for the envelope: 2e-4 x the row's peak, as in ``test_torch_envelope.py`` (fp32
rounding amplified by up to 1/(1 - cte)); the kernel contracts the
update into FMAs where the plain version rounds twice. The split kernel
(the main path's) equals the serial kernel bit for bit: both take the
same steps in the same arithmetic.

Card against CPU for the chain: 1e-3 of the peak (CPU_TOL of
``chip_smoke.py``), with TF32 off on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.chain.inference import ChainInference
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.fx.compressor import ballistics_cte
from remfx_tpu_torch.models import make_cnn14
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.ops.envelope import (CHUNK, envelope, envelope_flags,
                                          envelope_plain, envelope_serial)
from remfx_tpu_torch.ops.stft import hann_window, istft_ri

pytestmark = pytest.mark.cuda
SR = 48000
TOL = 2e-4
CPU_TOL = 1e-3
DEMO = Path(__file__).resolve().parents[1] / "demos" / "example_48k_mono.wav"
HIT = 4800  # samples of the hit before the silence


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(rows, T, seed=0):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((rows, T))).astype(np.float32)
    x *= np.linspace(0.05, 1.0, T, dtype=np.float32)
    attack = rng.uniform(1.0, 50.0, rows).astype(np.float32)
    attack[0] = 5e-4  # fast-attack edge: cte 0
    release = rng.uniform(10.0, 250.0, rows).astype(np.float32)
    at = ballistics_cte(torch.from_numpy(attack), SR)
    rl = ballistics_cte(torch.from_numpy(release), SR)
    return torch.from_numpy(x), at, rl


def _rel_err(got, want):
    peak = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    return ((got.cpu() - want).abs() / peak).max().item()


# 130 rows: two blocks; 5000 samples: 156 float4 chunks of 32 and a tail
@pytest.mark.parametrize("rows,T", [(3, 5000), (130, 5000), (8, 31)])
def test_kernel_matches_plain(cuda, rows, T):
    x, at, rl = _case(rows, T)
    before = envelope.launches
    got = envelope(x.to(cuda), at.to(cuda), rl.to(cuda))
    torch.cuda.synchronize()
    assert envelope.launches == before + 1
    assert _rel_err(got, envelope_plain(x, at, rl)) <= TOL


def test_unaligned_rows_take_the_scalar_path(cuda):
    # a row stride of 5001 floats leaves rows 1 and 2 off 16-byte alignment
    x, at, rl = _case(3, 5001, seed=1)
    got = envelope(x.to(cuda), at.to(cuda), rl.to(cuda))
    torch.cuda.synchronize()
    assert _rel_err(got, envelope_plain(x, at, rl)) <= TOL


def test_wrapper_raises_instead_of_falling_back(cuda):
    x, at, rl = _case(3, 100)
    with pytest.raises(TypeError):
        envelope(x.double().to(cuda), at.to(cuda), rl.to(cuda))
    with pytest.raises(ValueError):
        envelope(x.to(cuda), at, rl)  # coefficients left on the CPU


def test_istft_on_the_card_matches_the_cpu_for_a_non_hermitian_spectrum(cuda):
    """cuFFT and the CPU's FFT disagree on a real inverse FFT whose DC and
    Nyquist bins have imaginary parts; istft_ri zeroes them (1e-5 of the
    peak: fp32, another summation order)."""
    g = torch.Generator().manual_seed(0)
    re = torch.randn(2, 2049, 12, generator=g)
    im = torch.randn(2, 2049, 12, generator=g)
    w = hann_window(4096)
    want = istft_ri(re, im, 4096, 1024, w)
    got = istft_ri(re.to(cuda), im.to(cuda), 4096, 1024, w.to(cuda)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def _split_case(name, rows=4, T=65536):
    """Demo audio (|x|) with per-row attack/release at the corners of the
    compressor's ranges; the cases of test_torch_envelope.py's CPU model."""
    T = {"t_not_multiple_of_l": T + 500, "unaligned_rows": T + 1,
         "t_below_l": 200, "t_below_w": 8192}.get(name, T)
    x, _ = read_wav(DEMO)
    loop = np.tile(x[0], 2)  # the clip wrapped, so a window may cross its end
    starts = np.random.default_rng(0).integers(0, x.shape[1], rows)
    xa = np.stack([np.abs(loop[o:o + T]) for o in starts]).astype(np.float32)
    attack = np.resize(np.array([1.0, 50.0, 1.0, 50.0], np.float32), rows)
    release = np.resize(np.array([10.0, 250.0, 250.0, 10.0], np.float32), rows)
    if name == "hit_then_silence":
        xa[0, HIT:] = 0.0
        release[0] = 250.0
    elif name == "zero_row":
        xa[1] = 0.0
    elif name == "fast_attack":
        attack[:2] = 5e-4  # cte_at = 0
    at = ballistics_cte(torch.from_numpy(attack), SR)
    rl = ballistics_cte(torch.from_numpy(release), SR)
    return torch.from_numpy(xa), at, rl


@pytest.mark.parametrize("name", [
    "demo", "hit_then_silence", "zero_row", "fast_attack",
    "t_not_multiple_of_l", "unaligned_rows", "t_below_l", "t_below_w",
])
def test_split_kernel_equals_serial_kernel(cuda, name):
    x, at, rl = (t.to(cuda) for t in _split_case(name))
    before = envelope.launches, envelope_serial.launches
    got, unresolved = envelope_flags(x, at, rl)
    want = envelope_serial(x, at, rl)
    torch.cuda.synchronize()
    assert (envelope.launches, envelope_serial.launches) == (before[0] + 1,
                                                             before[1] + 1)
    assert unresolved.shape == (x.shape[0], -(-x.shape[1] // CHUNK))
    assert torch.equal(got, want)
    if name == "hit_then_silence":  # the bracket cannot close in silence
        assert unresolved[0, -1].item() == 1
    if name == "t_below_l":  # one chunk, started from 0
        assert not unresolved.any()
    if name == "t_below_w":  # the 250 ms rows warm up past T: all from 0
        assert not unresolved[1:3].any()


def test_split_kernel_equals_serial_kernel_on_stereo_batches(cuda):
    # 8 stereo examples: the render batch's rows at two channels each
    x, at, rl = (t.to(cuda) for t in _split_case("demo", rows=16, T=262144))
    got = envelope(x, at, rl)
    assert torch.equal(got, envelope_serial(x, at, rl))


def test_serial_kernel_matches_plain(cuda):
    x, at, rl = _case(3, 5000)
    got = envelope_serial(x.to(cuda), at.to(cuda), rl.to(cuda))
    assert _rel_err(got, envelope_plain(x, at, rl)) <= TOL


def test_chain_of_cpu_built_models_runs_without_tf32(cuda):
    """Models made on the CPU and moved to the card: the chain switches TF32
    off itself, and the card matches the CPU."""
    torch.manual_seed(0)
    cls = make_cnn14(device="cpu")
    demucs = ModelWrapper(HDemucs(sources=("mixture",), audio_channels=1,
                                  channels=8, nfft=64, depth=3), residual=True)
    slot = "RandomPedalboardCompressor"
    g = torch.Generator().manual_seed(0)
    x = 0.3 * torch.randn(2, 1, 8192, generator=g)
    labels = torch.zeros(2, len(ALL_EFFECTS))
    labels[:, ALL_EFFECTS.index("compressor")] = 1.0
    y_cpu, _ = ChainInference({slot: demucs}, SR, classifier=cls).remove(x, labels)
    with torch.no_grad():
        probs_cpu = cls(x)
    chain = ChainInference({slot: demucs.to(cuda)}, SR, classifier=cls.to(cuda))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    chain.detect(x.to(cuda))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    y, _ = chain.remove(x.to(cuda), labels.to(cuda))
    assert not torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        probs = cls(x.to(cuda)).cpu()
    assert (probs - probs_cpu).abs().max().item() <= CPU_TOL
    assert ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item() <= CPU_TOL


# ---- the signal paths of the five-slot chain, card against CPU ----

def test_asteroid_istft_on_the_card_matches_the_cpu(cuda):
    """DCUNet's decoder (a transposed filterbank conv, no FFT) on a random,
    non-Hermitian-looking spectrum, past its overlap-add length (1e-5 of
    the peak: fp32, another summation order)."""
    from remfx_tpu_torch.models.dcunet import asteroid_istft
    g = torch.Generator().manual_seed(1)
    re = torch.randn(2, 257, 40, generator=g)
    im = torch.randn(2, 257, 40, generator=g)
    want = asteroid_istft(re, im, 512, 10500)
    got = asteroid_istft(re.to(cuda), im.to(cuda), 512, 10500).cpu()
    assert not got[:, 10496:].any()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def _card_vs_cpu(model, x, cuda):
    want = model.sample(x)
    got = model.to(cuda).sample(x.to(cuda)).cpu()
    assert got.shape == want.shape
    return ((got - want).abs().max() / want.abs().max()).item()


def test_mini_dcunet_on_the_card_matches_the_cpu(cuda):
    from remfx_tpu_torch.models import make_dcunet
    torch.manual_seed(0)
    model = make_dcunet(device="cpu", architecture="Mini-DCUNet-6",
                        stft_kernel_size=64, identity_init=True)
    x = 0.3 * torch.randn(2, 1, 4000, generator=torch.Generator().manual_seed(2))
    assert _card_vs_cpu(model, x, cuda) <= CPU_TOL


def test_small_tcn_on_the_card_matches_the_cpu(cuda):
    from remfx_tpu_torch.models import make_tcn
    torch.manual_seed(0)
    model = make_tcn(device="cpu", nblocks=4, channel_width=8)
    x = 0.3 * torch.randn(2, 1, 4096, generator=torch.Generator().manual_seed(3))
    assert _card_vs_cpu(model, x, cuda) <= CPU_TOL


def test_multi_resolution_stft_loss_on_the_card_matches_the_cpu(cuda):
    from remfx_tpu_torch.losses import multi_resolution_stft_loss
    g = torch.Generator().manual_seed(4)
    y = 0.3 * torch.randn(2, 1, 16384, generator=g)
    x = 0.8 * y + 0.1 * torch.randn(2, 1, 16384, generator=g)
    want = multi_resolution_stft_loss(x, y).item()
    got = multi_resolution_stft_loss(x.to(cuda), y.to(cuda)).item()
    assert abs(got - want) <= 1e-5 * abs(want)


# ---- the data-synthesis path, card against CPU ----

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden_dsp.npz"
SYNTH_EFFECTS = ["distortion", "compressor", "limiter", "delay", "reverb", "chorus",
                 "parametric_eq", "volume_automation", "stereo_widener"]


def _clips(rows, C, T, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, C, T, generator=g) * torch.linspace(0.2, 1.0, T)
    return 0.5 * x / x.abs().max()


@pytest.mark.parametrize("name", SYNTH_EFFECTS)
def test_effect_on_the_card_matches_the_cpu(cuda, name):
    """Each effect's batched render, card against CPU, 1e-4 of the peak:
    the tolerance of the FFT effects against JAX (cuFFT and pocketfft sum
    in other orders; the dynamics run the kernel against the plain loop,
    2e-4 of the row peak on the envelope itself)."""
    from remfx_tpu_torch.fx import make_effect
    from remfx_tpu_torch.ops.envelope import envelope as env
    C = 2 if name == "stereo_widener" else 1
    x = _clips(3, C, 48000)
    cpu = make_effect(name, SR, device="cpu")
    card = make_effect(name, SR, device=cuda)
    params = cpu.sample_params(torch.Generator().manual_seed(1), 3)
    want = cpu.render_batch(x, params)
    before = env.launches
    got = card.render_batch(x.to(cuda), {k: v.to(cuda) for k, v in params.items()})
    torch.cuda.synchronize()
    launches = {"compressor": 1, "limiter": 2}.get(name, 0)
    assert env.launches == before + launches
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("effect,tol", [("distortion", 2e-6), ("delay", 2e-4),
                                        ("compressor", 1e-4), ("limiter", 1e-4),
                                        ("chorus", 2e-4), ("reverb", 5e-4)])
def test_effect_on_the_card_matches_the_golden_fixtures(cuda, effect, tol):
    """The C++ oracle's outputs, at tests/test_golden_fixtures.py's
    absolute tolerances."""
    from remfx_tpu_torch.fx import make_effect
    golden = np.load(GOLDEN)
    x = torch.from_numpy(golden["input"][None]).to(cuda)
    idxs = sorted({k.split("/")[1] for k in golden.files if k.startswith(f"{effect}/")})
    for i in idxs:
        p = {k.split("/param/")[1]: float(golden[k]) for k in golden.files
             if k.startswith(f"{effect}/{i}/param/")}
        kw = {}
        if effect == "chorus":
            p["centre_delay_ms"] = p.pop("centre_ms")
        elif effect == "reverb":
            p = {"room_size": p["room_size"], "damping": p["damping"],
                 "wet_dry": p["wet_level"], "width": p["width"]}
            kw = {"max_room_size": max(0.5, p["room_size"])}
        elif effect == "delay":
            kw = {"max_delay_sconds": 0.3}
        eff = make_effect(effect, SR, device=cuda, **kw)
        y = eff.render(x, {k: torch.tensor(v, device=cuda) for k, v in p.items()})
        ref = golden[f"{effect}/{i}/output"]
        assert np.abs(y[0].cpu().numpy() - ref).max() < tol, p


def test_integrated_loudness_on_the_card_matches_the_cpu(cuda):
    """float64 filters and sums on both: 1e-5 LU."""
    from remfx_tpu_torch.ops.loudness import integrated_loudness
    x = _clips(4, 2, 3 * SR, seed=2)
    x[3] = 0.0  # silence: -inf on both
    want = integrated_loudness(x, SR)
    got = integrated_loudness(x.to(cuda), SR).cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want)) and torch.isinf(got[3])
    assert (got[:3] - want[:3]).abs().max().item() <= 1e-5


def test_irfft_on_the_card_matches_the_cpu_for_a_non_hermitian_spectrum(cuda):
    """Imaginary parts at DC and Nyquist are zeroed before cuFFT, as the
    JAX package's inverse ignores them (1e-5 of the peak)."""
    from remfx_tpu_torch.ops.fft import irfft_ri
    g = torch.Generator().manual_seed(3)
    n = 2 ** 20
    re = torch.randn(2, n // 2 + 1, generator=g)
    im = torch.randn(2, n // 2 + 1, generator=g)
    want = irfft_ri(re, im, n)
    got = irfft_ri(re.to(cuda), im.to(cuda), n).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_render_batch_on_the_card_matches_the_cpu(cuda):
    """The dataset's chain at its default configuration, one seed: equal
    labels, outputs within 1e-4 of the peak."""
    from remfx_tpu_torch.augment import EffectChainRenderer
    from remfx_tpu_torch.config.core import default_config
    cfg = default_config()

    def renderer(dev):
        return EffectChainRenderer(
            SR, cfg["effects_to_keep"], cfg["effects_to_remove"],
            cfg["num_kept_effects"], cfg["num_removed_effects"],
            cfg["shuffle_kept_effects"], cfg["shuffle_removed_effects"],
            effect_overrides=cfg["effects"], device=dev)

    x = _clips(4, 1, 65536, seed=4)
    want = renderer("cpu").render_batch(torch.Generator().manual_seed(0), x)
    got = renderer(cuda).render_batch(torch.Generator().manual_seed(0), x.to(cuda))
    for g_, w in zip(got[2:], want[2:]):
        assert torch.equal(g_.cpu(), w)
    for g_, w in zip(got[:2], want[:2]):
        assert ((g_.cpu() - w).abs().max() / w.abs().max()).item() <= 1e-4


# ---- the training path, card against CPU ----

def _train_step(name, net, T, dev, seed=0):
    """One RemovalTask.train_step of a small model from seeded weights on a
    seeded batch: (loss, parameters and buffers after the step)."""
    from remfx_tpu_torch.models import make_model
    from remfx_tpu_torch.train.tasks import RemovalTask
    from remfx_tpu_torch.utils.device import resolve_device
    torch.manual_seed(seed)
    # built on the CPU, moved as the port's entry points move it: TF32 off
    w = make_model(name, sample_rate=SR, device="cpu", **net).to(resolve_device(dev))
    x = _clips(2, 1, T, seed=seed + 1)
    y = 0.5 * torch.tanh(2 * x)
    task = RemovalTask(w, max_steps=100)
    _, m = task.train_step(task.init_state(), (x.to(dev), y.to(dev)))
    return m["train_loss"].item(), {k: v.detach().cpu() for k, v in w.state_dict().items()}


@pytest.mark.parametrize("name,net,T", [
    ("demucs", dict(channels=8, nfft=256, depth=4), 16384),
    ("dcunet", dict(architecture="Mini-DCUNet-6", stft_kernel_size=64, norm_type="bN"), 8000),
])
def test_train_step_on_the_card_matches_the_cpu(cuda, name, net, T):
    """The loss to 1e-5 relative; the parameters within 2.05 lr and 99.9%
    of their elements within 0.05 lr (Adam moves each by about lr = 1e-4 a
    step whatever its gradient's size, so a gradient near zero whose sign
    the two devices round differently moves by up to 2 lr); the running
    statistics to 1e-5 of their largest value."""
    loss_cpu, sd_cpu = _train_step(name, net, T, "cpu")
    loss_card, sd_card = _train_step(name, net, T, cuda)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    errs = []
    for k, want in sd_cpu.items():
        got = sd_card[k]
        if "running" in k:
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item(), k
        elif "num_batches" in k:
            assert torch.equal(got, want)
        else:
            errs.append((got - want).abs().ravel())
    errs = torch.cat(errs)
    assert errs.max().item() <= 2.05e-4
    assert (errs > 0.05e-4).float().mean().item() <= 1e-3


def test_batchnorm_running_statistics_on_the_card(cuda):
    """flax's update (the biased variance) on the card as on the CPU:
    1e-6 relative; the train-mode output to 1e-5."""
    from remfx_tpu_torch.models.batchnorm import BatchNorm2d
    g = torch.Generator().manual_seed(5)
    x = 2 * torch.randn(8, 16, 33, 40, generator=g) + 0.5
    cpu = BatchNorm2d(16).train()
    card = BatchNorm2d(16).to(cuda).train()
    for _ in range(3):
        want = cpu(x)
        got = card(x.to(cuda)).cpu()
    assert (got - want).abs().max().item() <= 1e-5
    for k in ("running_mean", "running_var"):
        w, c = getattr(cpu, k), getattr(card, k).cpu()
        assert (c - w).abs().max().item() <= 1e-6 * w.abs().max().item(), k
    var = x.var(dim=(0, 2, 3), unbiased=False)
    assert (cpu.running_var - (0.9 ** 3 + (1 - 0.9 ** 3) * var)).abs().max().item() <= 1e-5


def test_dynamic_batch_on_the_card(cuda):
    """compression_aug's dynamic batch rendered on the card, left there:
    every row compressed, 0-4 kept effects, -20 LUFS within 0.01 LU."""
    from remfx_tpu_torch.data.datasets import DynamicEffectDataset
    from remfx_tpu_torch.ops.loudness import integrated_loudness
    ds = DynamicEffectDataset(
        total_chunks=8, mode="train", sample_rate=SR, chunk_size=65536, seed=3,
        effects_to_keep=["distortion", "chorus", "delay", "reverb"],
        effects_to_remove=["compressor"], num_kept_effects=[0, 4],
        num_removed_effects=[1, 1], synthetic=True, device=cuda)
    before = envelope.launches
    wet, dry, dl, wl = ds.get_batch(np.arange(8))
    assert envelope.launches >= before + 1
    assert all(t.device.type == "cuda" for t in (wet, dry, dl, wl))
    assert wet.shape == (8, 1, 65536)
    comp = ALL_EFFECTS.index("compressor")
    assert bool((wl[:, comp] == 1).all() and (wl.sum(1) == 1).all())
    assert bool((dl[:, comp] == 0).all()) and int(dl.sum(1).max()) <= 4
    lufs = torch.cat([integrated_loudness(wet, SR), integrated_loudness(dry, SR)])
    assert (lufs + 20).abs().max().item() <= 0.01


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A TrainState saved from the card and restored into another is equal
    bit for bit: parameters, AdamW's moments, the schedule, the counters."""
    from remfx_tpu_torch.models import make_model
    from remfx_tpu_torch.train.checkpoint import CheckpointManager
    from remfx_tpu_torch.train.tasks import RemovalTask

    def task():
        torch.manual_seed(0)
        return RemovalTask(make_model("tcn", nblocks=3, channel_width=8, kernel_size=3,
                                      dilation_growth=2, device=cuda), max_steps=4)

    t1 = task()
    s1 = t1.init_state()
    x = _clips(2, 1, 4096).to(cuda)
    for _ in range(3):
        t1.train_step(s1, (x, 0.5 * x))
    CheckpointManager(str(tmp_path)).save_last(s1, step=3)
    t2 = task()
    s2 = t2.init_state()
    CheckpointManager(str(tmp_path)).restore(s2, "last")
    a, b = s1.state_dict(), s2.state_dict()
    assert all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    for pa, pb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k].to(cuda), pb[k].to(cuda)) for k in pa)
    assert a["scheduler"] == b["scheduler"] and (s2.step, s2.mini_step) == (3, 0)
    assert s2.optimizer.param_groups[0]["lr"] == s1.optimizer.param_groups[0]["lr"]


CKPTS = Path(__file__).resolve().parents[1] / "ckpts"


@pytest.mark.parametrize("name", ["tcn_distortion_aug", "dcunet_reverb_aug_r4",
                                  "classifier_cnn14_r5"])
def test_trained_weights_read_onto_the_card(cuda, name):
    """The port's orbax reader and loaders (no JAX) put a vendored
    checkpoint's weights on the card, equal bit for bit to the CPU's."""
    from remfx_tpu_torch.train.checkpoint import (load_trained_classifier,
                                                  load_trained_wrapper)

    if name.startswith("classifier"):
        on_card = load_trained_classifier(CKPTS / name, device=cuda)
        on_cpu = load_trained_classifier(CKPTS / name, device="cpu")
    else:
        on_card = load_trained_wrapper(CKPTS / name, device=cuda)[1]
        on_cpu = load_trained_wrapper(CKPTS / name, device="cpu")[1]
    a, b = on_card.state_dict(), on_cpu.state_dict()
    assert set(a) == set(b)
    assert all(v.device.type == "cuda" and torch.equal(v.cpu(), b[k])
               for k, v in a.items())


@pytest.mark.parametrize("name", ["tcn_distortion_aug", "dcunet_reverb_aug_r4"])
def test_trained_slot_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    """A trained removal slot on 65536 samples of a demo clip: card
    against CPU within 1e-3 of the peak, TF32 off; the DCUNet's inference
    on both: the epilogue kernel on the card, its plain version on the
    CPU."""
    from remfx_tpu_torch.models import dcunet as dcunet_module
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue
    from remfx_tpu_torch.train.checkpoint import load_trained_wrapper

    calls = []  # the device of each epilogue call of the masker

    def counted(*args, **kwargs):
        calls.append(args[0].device.type)
        return dcunet_epilogue(*args, **kwargs)

    monkeypatch.setattr(dcunet_module, "dcunet_epilogue", counted)
    x, _ = read_wav(DEMO)
    x = torch.from_numpy(np.ascontiguousarray(x[None, :, :65536], np.float32))
    _, on_card = load_trained_wrapper(CKPTS / name, device=cuda)
    _, on_cpu = load_trained_wrapper(CKPTS / name, device="cpu")
    before = dcunet_epilogue.launches
    got = on_card.sample(x.to(cuda)).cpu()
    launched = dcunet_epilogue.launches - before
    want = on_cpu.sample(x)
    if name.startswith("dcunet"):  # the kernel on the card, the plain version on the CPU
        blocks = 2 * len(on_card.module.stages) - 1
        assert launched == blocks
        assert calls == ["cuda"] * blocks + ["cpu"] * blocks
        assert dcunet_epilogue.launches == before + blocks
    assert got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= CPU_TOL


# ---------------------------------------------------------------- the phaser

def _phaser_case(B, C, T, seed=0):
    """Input, the coefficient (formed on the card, then shared by both
    versions), feedback and mix, all on the card."""
    from remfx_tpu_torch.fx import phaser as tph

    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.5 * rng.standard_normal((B, C, T))).astype(np.float32))
    params = {k: torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32)).cuda()
              for k, lo, hi in (("rate_hz", 0.25, 5.0), ("depth", 0.1, 0.6),
                                ("centre_frequency_hz", 200.0, 200.0),
                                ("feedback", 0.1, 0.6), ("mix", 0.1, 0.7))}
    a = tph.coefficients(params, T, SR, torch.device("cuda"))
    return x.cuda(), a, params["feedback"], params["mix"]


# 40 rows: two blocks; 5000 samples: 156 lines of 32 and a tail; 31: the tail
# alone; 8 x 2 x 16384: the channel's shape, cut in time
PHASER_SHAPES = [(3, 1, 5000), (20, 2, 1000), (8, 2, 31), (8, 2, 16384)]


@pytest.mark.parametrize("B,C,T", PHASER_SHAPES)
def test_phaser_kernel_equals_plain_bit_for_bit(cuda, B, C, T):
    """Every product and sum of the serial kernel rounds to nearest in the
    plain version's order (no FMA), so the two agree bit for bit, the plain
    version run on the host from the same coefficient."""
    from remfx_tpu_torch.ops.phaser import phaser_plain, phaser_serial

    x, a, fb, mix = _phaser_case(B, C, T)
    before = phaser_serial.launches
    got = phaser_serial(x, a, fb, mix)
    torch.cuda.synchronize()
    assert phaser_serial.launches == before + 1
    want = phaser_plain(x.cpu(), a.cpu(), fb.cpu(), mix.cpu())
    assert torch.equal(got.cpu(), want)


def test_phaser_unaligned_rows_take_the_scalar_path(cuda):
    # a row stride of 4097 floats leaves rows 1 and 2 off 16-byte alignment
    from remfx_tpu_torch.ops.phaser import phaser_plain, phaser_serial

    x, a, fb, mix = _phaser_case(3, 1, 4097, seed=1)
    got = phaser_serial(x, a, fb, mix)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), phaser_plain(x.cpu(), a.cpu(), fb.cpu(), mix.cpu()))


def _phaser_hard_case(T, seed=0):
    """The slowest poles (rate 0.25 Hz, depth 0.6, feedback 0.6, from sample
    140000 of the LFO: a near -0.9968) for 2 examples x 2 channels, the
    second a loud burst then digital silence."""
    from remfx_tpu_torch.fx import phaser as tph

    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 2, T))).astype(np.float32))
    x[1, :, 200:] = 0.0
    params = {k: torch.full((2,), v, device="cuda")
              for k, v in (("rate_hz", 0.25), ("depth", 0.6), ("centre_frequency_hz", 200.0),
                           ("feedback", 0.6), ("mix", 0.7))}
    a = tph.coefficients(params, 140000 + T, SR, torch.device("cuda"))[:, 140000:]
    return x.cuda(), a.contiguous(), params["feedback"], params["mix"]


def _row_rel(got, want):
    peak = want.abs().amax(dim=-1, keepdim=True)
    return ((got - want).abs() / peak).max().item()


def _split_against_plain(x, a, fb, mix):
    from remfx_tpu_torch.ops.phaser import SPLIT_TOL, phaser, phaser_plain

    before = phaser.launches
    got = phaser(x, a, fb, mix)
    torch.cuda.synchronize()
    assert phaser.launches == before + 1  # one a call, three device kernels
    assert bool(torch.isfinite(got).all())
    want = phaser_plain(x.cpu(), a.cpu(), fb.cpu(), mix.cpu())
    assert _row_rel(got.cpu(), want) <= SPLIT_TOL


@pytest.mark.parametrize("B,C,T", PHASER_SHAPES + [(3, 1, 4097)])
def test_split_phaser_kernel_within_its_tolerance_of_plain(cuda, B, C, T):
    """The split kernel (the default) against the plain version on the host,
    within ``SPLIT_TOL`` of each row's peak; (3, 1, 4097): rows off 16-byte
    alignment."""
    _split_against_plain(*_phaser_case(B, C, T, seed=2))


@pytest.mark.parametrize("n", ["1", "L-1", "L", "5L+3", "33L+5"])
def test_split_phaser_kernel_on_the_hard_rows(cuda, n):
    from remfx_tpu_torch.ops.phaser import CHUNK as L

    T = {"1": 1, "L-1": L - 1, "L": L, "5L+3": 5 * L + 3, "33L+5": 33 * L + 5}[n]
    _split_against_plain(*_phaser_hard_case(T))


def test_phaser_wrapper_raises_instead_of_falling_back(cuda, monkeypatch):
    from remfx_tpu_torch.ops import phaser as ops_phaser

    x, a, fb, mix = _phaser_case(2, 1, 100)
    wrappers = (ops_phaser.phaser, ops_phaser.phaser_serial)
    for fn in wrappers:
        with pytest.raises(TypeError):
            fn(x.double(), a, fb, mix)
        with pytest.raises(ValueError):
            fn(x, a.cpu(), fb, mix)  # coefficient left on the CPU

    class Refused:
        @staticmethod
        def remfx_phaser(*args):
            return 9  # cudaErrorInvalidConfiguration

        remfx_phaser_serial = remfx_phaser

    monkeypatch.setattr(ops_phaser, "_lib", lambda: Refused)
    for fn in wrappers:
        before = fn.launches
        with pytest.raises(RuntimeError, match="phaser kernel launch failed"):
            fn(x, a, fb, mix)
        assert fn.launches == before

    def no_compiler():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops_phaser, "_lib", no_compiler)
    for fn in wrappers:
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(x, a, fb, mix)


# ---------------------------------------------------------------- HDemucs's GroupNorm

# the kernel in bf16 against the plain composition computed in fp32 from the
# same bf16 inputs: one rounding to bf16 (2**-9 of the value) and fp32 sums
# taken in another order; 1e-3 absolute where the value is near 0
GN_RTOL, GN_ATOL = 2**-8, 1e-3
GN_ACTS = ["gelu", "glu", "glu+residual"]


def _gn_case(shape, groups, act, dtype, seed=0):
    """x, weight, bias and the residual and LayerScale (or None) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[1]

    def randn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(dtype)

    x = (0.3 + randn(*shape))
    w, b = 1.0 + 0.5 * randn(C), 0.1 * randn(C)
    if act != "glu+residual":
        return x, groups, w, b, act.split("+")[0], None, None
    return x, groups, w, b, "glu", randn(shape[0], C // 2, *shape[2:]), 0.3 * randn(C // 2)


def _gn_fp32_plain(x, groups, w, b, act, res, scale):
    from remfx_tpu_torch.ops.group_norm import group_norm_plain

    f = [None if t is None else t.float() for t in (x, w, b, res, scale)]
    return group_norm_plain(f[0], groups, f[1], f[2], 1e-5, act, f[3], f[4])


@pytest.mark.parametrize("act", GN_ACTS)
@pytest.mark.parametrize("shape", [(24, 96, 65536), (12288, 96, 256)])
def test_group_norm_kernel_at_the_chains_shapes(cuda, shape, act):
    """The chain's largest time-branch norm and a frequency-branch one of
    HDemucs (24 rows, bf16): the kernel against the fp32 composition, two
    calls bit for bit, one launch a call."""
    from remfx_tpu_torch.ops.group_norm import group_norm

    case = _gn_case(shape, 1, act, torch.bfloat16)
    before = group_norm.launches
    with torch.no_grad():
        got = group_norm(*case[:4], 1e-5, *case[4:])
        again = group_norm(*case[:4], 1e-5, *case[4:])
    torch.cuda.synchronize()
    assert group_norm.launches == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    torch.testing.assert_close(got.float(), _gn_fp32_plain(*case), rtol=GN_RTOL, atol=GN_ATOL)


# (40, 8, 1003) and (24, 768, 258): no multiple of the pack, element by
# element; (24, 768, 1, 256): 4-d, in four groups; (3, 8, 37): 12 groups
# of rows, each one chunk
@pytest.mark.parametrize("act", GN_ACTS)
@pytest.mark.parametrize("shape,groups", [((40, 8, 1003), 4), ((24, 768, 258), 4),
                                          ((24, 768, 1, 256), 4), ((3, 8, 37), 4),
                                          ((4, 192, 16384), 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_matches_plain(cuda, shape, groups, act, dtype):
    from remfx_tpu_torch.ops.group_norm import group_norm

    if act == "glu+residual" and len(shape) == 4:
        shape = shape[:2] + shape[3:]  # the DConv's residual is 3-d
    case = _gn_case(shape, groups, act, dtype, seed=1)
    with torch.no_grad():
        got = group_norm(*case[:4], 1e-5, *case[4:])
    want = _gn_fp32_plain(*case)
    if dtype == torch.float32:  # fp32 sums in another order than torch's
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want, rtol=GN_RTOL, atol=GN_ATOL)


def test_group_norm_wrapper_raises_instead_of_falling_back(cuda):
    from remfx_tpu_torch.ops.group_norm import group_norm

    x, groups, w, b, *_ = _gn_case((2, 8, 64), 1, "gelu", torch.float32)
    with torch.no_grad():
        with pytest.raises(TypeError):
            group_norm(x.half(), groups, w.half(), b.half())
        with pytest.raises(ValueError, match="contiguous"):
            group_norm(x.transpose(1, 2).contiguous().transpose(1, 2), groups, w, b)
        with pytest.raises(TypeError):
            group_norm(x, groups, w.cpu(), b)


def _gn_grads(fn, case, grad):
    """The output of ``fn`` (group_norm or its plain version) on fresh leaves
    of ``case`` that require grad, and their gradients for ``grad``."""
    x, groups, w, b, act, res, scale = case
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in (x, w, b, res, scale)]
    with torch.enable_grad():
        out = fn(leaves[0], groups, leaves[1], leaves[2], 1e-5, act, *leaves[3:])
    got = torch.autograd.grad(out, [t for t in leaves if t is not None], grad)
    return [out.detach(), *got]


@pytest.mark.parametrize("act", GN_ACTS)
@pytest.mark.parametrize("shape,groups", [((24, 96, 4096), 1), ((12288 // 8, 96, 256), 1),
                                          ((24, 768, 258), 4), ((8, 384, 1, 1028), 4)])
def test_group_norm_kernel_gradients_match_plain(cuda, shape, groups, act):
    """Under autograd the kernel launches (with its statistics) and its
    backward pass gives the gradients of torch's composition: in fp32 within
    1e-4 of each gradient's peak; in bf16 no further from the fp32
    gradients than torch's own bf16 composition, give or take a bf16
    rounding of the peak."""
    from remfx_tpu_torch.ops.group_norm import group_norm, group_norm_plain

    if act == "glu+residual" and len(shape) == 4:
        shape = shape[:2] + shape[3:]
    case = _gn_case(shape, groups, act, torch.float32, seed=2)
    out_shape = (shape[0], shape[1] // 2 if act != "gelu" else shape[1], *shape[2:])
    grad = torch.randn(out_shape, generator=torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    before = group_norm.launches
    got = _gn_grads(group_norm, case, grad)
    assert group_norm.launches == before + 1
    want = _gn_grads(group_norm_plain, case, grad)
    for a, e in zip(got, want):
        assert ((a - e).abs().max() / e.abs().max()).item() <= 1e-4
    half = [t.to(torch.bfloat16) if torch.is_tensor(t) else t for t in case]
    got16 = _gn_grads(group_norm, half, grad.to(torch.bfloat16))
    torch16 = _gn_grads(group_norm_plain, half, grad.to(torch.bfloat16))
    for a, t, e in zip(got16, torch16, want):
        peak = e.abs().max()
        err, torch_err = ((a.float() - e).abs().max() / peak).item(), \
            ((t.float() - e).abs().max() / peak).item()
        assert err <= 2 * torch_err + 2**-8, (err, torch_err)


@pytest.mark.parametrize("rows", [1, 2])
def test_hdemucs_on_the_card_runs_the_kernel_for_every_norm(cuda, monkeypatch, rows):
    """An HDemucs forward launches the kernel for every norm, in no-grad
    mode and under autograd alike; the two outputs are equal, and output and
    gradients agree with torch's composition forced in its place within
    1e-5 and 1e-4 of their peaks (TF32 off: a TF32 convolution would round
    the two paths' last-digit differences to its 10-bit mantissa)."""
    from remfx_tpu_torch.models import demucs
    from remfx_tpu_torch.ops.group_norm import group_norm, group_norm_plain

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.manual_seed(0)
    cfg = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64, depth=3,
               norm_starts=1, dconv_lstm=2, dconv_attn=1)
    model = HDemucs(**cfg).cuda()
    x = 0.1 * torch.randn(rows, 1, 4096, device="cuda")
    norms = sum(1 for m in model.modules() if type(m).__name__ == "GroupNormAct")
    before = group_norm.launches
    with torch.no_grad():
        fused = model(x)
    assert group_norm.launches == before + norms
    ramp = torch.linspace(-1.0, 1.0, x.shape[-1], device="cuda")

    def forward_and_grads():
        model.zero_grad()
        with torch.enable_grad():
            y = model(x)
            (y * ramp).square().sum().backward()
        return [y.detach()] + [p.grad.clone() for p in model.parameters()]

    traced = forward_and_grads()
    assert group_norm.launches == before + 2 * norms
    assert torch.equal(fused, traced[0])
    monkeypatch.setattr(demucs, "group_norm", group_norm_plain)
    plain = forward_and_grads()
    assert group_norm.launches == before + 2 * norms
    assert ((traced[0] - plain[0]).abs().max() / plain[0].abs().max()).item() <= 1e-5
    # a leaf whose gradient is nought by construction (the attention's key
    # bias, which the softmax cancels) holds rounding noise on both paths:
    # each leaf against its peak, or 1e-6 of the largest leaf's where higher
    top = max(e.abs().max().item() for e in plain[1:])
    for a, e in zip(traced[1:], plain[1:]):
        peak = max(e.abs().max().item(), 1e-6 * top)
        assert (a - e).abs().max().item() / peak <= 1e-4


# ---------------------------------------------------------------- the DCUNet's epilogue

def _epi_case(kind, C, S, shape, dtype, padded=True, seed=0):
    """x (B, xw, H, W) channels-last, the norm's coefficients and the
    skip (B, sw, H, W) or None, on the card: widths padded to multiples of 8
    with random values past the 2C and 2S read (``padded``), or 2C and 2S."""
    from remfx_tpu_torch.models.dcunet import ComplexBatchNorm, OnReImBatchNorm
    from remfx_tpu_torch.ops.dcunet_epilogue import packed_width

    g = torch.Generator().manual_seed(seed)
    norm = ComplexBatchNorm(C) if kind == "CbN" else OnReImBatchNorm(C)
    with torch.no_grad():
        for t in norm.parameters():
            t.add_(0.2 * torch.randn(t.shape, generator=g))
        for name, t in norm.named_buffers():
            if "mean" in name:
                t.uniform_(-0.3, 0.3, generator=g)
            elif "covar" in name:
                t.copy_(torch.tensor([1.3, 0.4, 0.8]).repeat(C, 1))
            elif "var" in name:
                t.uniform_(0.5, 2.0, generator=g)
    B, H, W = shape
    width = packed_width if padded else (lambda n: n)
    gd = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, H, W, width(2 * C), generator=gd, device="cuda").to(dtype)
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        coef = norm.eval().cuda().coefficients(x)
    skip = None
    if S:
        skip = torch.randn(B, H, W, width(2 * S), generator=gd, device="cuda").to(dtype)
        skip = skip.permute(0, 3, 1, 2)
    return x, coef, skip, 2 * S


def _epi_check(got, x, coef, skip, skip_channels):
    """The kernel against the plain version computed in fp32 from the same
    inputs: fp32 within 1e-6 of the peak, bf16 within one rounding; the
    skip's channels and the zeros after them bit for bit."""
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue_plain, packed_width

    want = dcunet_epilogue_plain(x.float(), coef, None if skip is None else skip.float(),
                                 skip_channels)
    C2 = coef.shape[1] * 2
    width = C2 + skip_channels
    assert got.dtype == x.dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape[1] == packed_width(width) and not got[:, width:].any()
    if skip is not None:
        assert torch.equal(got[:, C2:width], skip[:, :skip_channels])
    got, want = got[:, :C2], want[:, :C2]
    if x.dtype == torch.float32:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
    else:
        torch.testing.assert_close(got.float(), want, rtol=2**-8, atol=1e-6)


# (C, S, (B, H, W)): the encoders' 45, 90 and 128 complex channels, a
# decoder's 90 + 90 and 45 + 45, and 13 frames (no multiple of 8)
EPI_SHAPES = [(45, 0, (3, 17, 13)), (90, 0, (2, 9, 40)), (128, 0, (2, 5, 13)),
              (90, 90, (2, 9, 13)), (45, 45, (3, 17, 40)), (3, 2, (2, 5, 7))]


@pytest.mark.parametrize("C,S,shape", EPI_SHAPES)
@pytest.mark.parametrize("kind", ["bN", "CbN"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "tight"])
def test_dcunet_epilogue_kernel_matches_plain(cuda, C, S, shape, kind, dtype, padded):
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue

    x, coef, skip, s2 = _epi_case(kind, C, S, shape, dtype, padded)
    before = dcunet_epilogue.launches
    with torch.no_grad():
        got = dcunet_epilogue(x, coef, skip, s2)
    torch.cuda.synchronize()
    assert dcunet_epilogue.launches == before + 1
    _epi_check(got, x, coef, skip, s2)


@pytest.mark.parametrize("S", [0, 45])
def test_dcunet_epilogue_unaligned_tensors_take_the_scalar_path(cuda, S):
    """A batch slice whose start is not on 16 bytes (17 x 13 pixels of 90
    bf16 values a row) runs element by element, with the same result."""
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue

    x, coef, skip, s2 = _epi_case("bN", 45, S, (3, 17, 13), torch.bfloat16, padded=False)
    x = x[1:]
    skip = None if skip is None else skip[1:]
    assert x.data_ptr() % 16
    with torch.no_grad():
        got = dcunet_epilogue(x, coef, skip, s2)
    _epi_check(got, x, coef, skip, s2)


@pytest.mark.parametrize("S", [0, 45])
def test_dcunet_epilogue_kernel_at_the_chains_shape(cuda, S):
    """24 rows of a Large-DCUNet-20 stage at 262144 samples, bf16: 45
    complex channels over 257 x 1025, packed in 96, an encoder and the last
    decoder with its skip; two calls bit for bit."""
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue

    x, coef, skip, s2 = _epi_case("bN", 45, S, (24, 257, 1025), torch.bfloat16)
    with torch.no_grad():
        got = dcunet_epilogue(x, coef, skip, s2)
        again = dcunet_epilogue(x, coef, skip, s2)
    assert torch.equal(got, again)
    _epi_check(got, x, coef, skip, s2)


def test_dcunet_epilogue_wrapper_raises_instead_of_falling_back(cuda):
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue

    x, coef, skip, s2 = _epi_case("bN", 5, 3, (2, 4, 8), torch.float32)
    with torch.no_grad():
        with pytest.raises(TypeError):
            dcunet_epilogue(x.half(), coef, skip.half(), s2)
        with pytest.raises(ValueError, match="channels-last"):
            dcunet_epilogue(x.contiguous(), coef, skip, s2)
        with pytest.raises(ValueError, match="channels-last"):
            dcunet_epilogue(x, coef, skip.contiguous(), s2)
        with pytest.raises(TypeError):
            dcunet_epilogue(x, coef, skip.cpu(), s2)
        with pytest.raises(TypeError):
            dcunet_epilogue(x, coef.cpu(), skip, s2)
        with pytest.raises(TypeError):
            dcunet_epilogue(x, coef.double(), skip, s2)
        with pytest.raises(ValueError):
            dcunet_epilogue(x, coef, skip, skip.shape[1] + 2)
    from remfx_tpu_torch.ops.dcunet_epilogue import _fused, dcunet_epilogue_plain
    with pytest.raises(ValueError, match="backward"):
        _fused(x.detach().requires_grad_(), coef, skip, s2, 0.01)
    # where autograd records, the op itself takes the plain version
    before = dcunet_epilogue.launches
    xg = x.detach().requires_grad_()
    got = dcunet_epilogue(xg, coef, skip, s2)
    assert dcunet_epilogue.launches == before and got.requires_grad
    assert torch.equal(got, dcunet_epilogue_plain(xg, coef, skip, s2))


@pytest.mark.parametrize("norm_type", ["bN", "CbN"])
def test_large_dcunet_on_the_card_takes_the_packed_path(cuda, norm_type):
    """A Large-DCUNet-20 inference on the card: 19 epilogue launches (10
    encoders, 9 decoders) and the CPU's output within 1e-3 of the peak
    (fp32, TF32 off). An eval forward that autograd records and a train-mode
    forward run the plain epilogue: no launch; the recorded one equals
    inference within the same bound."""
    from remfx_tpu_torch.models import make_dcunet
    from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue

    torch.manual_seed(0)
    model = make_dcunet(device="cpu", norm_type=norm_type, identity_init=True)
    x = 0.3 * torch.randn(2, 1, 8192, generator=torch.Generator().manual_seed(2))
    want = model.sample(x)
    model.to(cuda)
    before = dcunet_epilogue.launches
    got = model.sample(x.to(cuda)).cpu()
    assert dcunet_epilogue.launches == before + 19
    assert ((got - want).abs().max() / want.abs().max()).item() <= CPU_TOL
    recorded = model.module(x.to(cuda))
    assert recorded.requires_grad
    recorded = recorded.detach().cpu()
    assert ((recorded - want).abs().max() / want.abs().max()).item() <= CPU_TOL
    model.module.train()(x.to(cuda)).square().sum().backward()
    assert dcunet_epilogue.launches == before + 19


def test_large_dcunet_at_the_chains_shape_transposes_nothing(cuda):
    """A Large-DCUNet-20 inference as the chain runs it (bf16, 24 x 262144):
    no cuDNN layout transpose and no cat inside the model. (At small shapes
    cuDNN's heuristics pick NCHW kernels for some convolutions, and
    transpose around them.)"""
    from torch.profiler import ProfilerActivity, profile

    from remfx_tpu_torch.models import make_dcunet

    torch.manual_seed(0)
    model = make_dcunet(device=cuda).to(torch.bfloat16)
    x = (0.1 * torch.randn(24, 1, 262144, device=cuda)).to(torch.bfloat16)
    model.sample(x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.sample(x)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n or "CatArray" in n
                or "AddPadding" in n]
