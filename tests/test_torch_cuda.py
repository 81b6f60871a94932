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
