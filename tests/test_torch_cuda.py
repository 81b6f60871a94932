"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.

Tolerance for the envelope: 2e-4 x the row's peak, as in ``test_torch_envelope.py`` (fp32
rounding amplified by up to 1/(1 - cte)); the kernel contracts the
update into FMAs where the plain version rounds twice.
"""

import numpy as np
import pytest
import torch

from remfx_tpu_torch.fx.compressor import ballistics_cte
from remfx_tpu_torch.ops.envelope import envelope, envelope_plain
from remfx_tpu_torch.ops.stft import hann_window, istft_ri

pytestmark = pytest.mark.cuda
SR = 48000
TOL = 2e-4


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
