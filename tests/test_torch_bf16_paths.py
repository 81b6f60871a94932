"""bf16 on four ported paths that ``tests/test_torch_dtype.py`` does not
reach: ``stream_chain``, ``PipelineChain``, the time windows of
``parallel/sequence.py`` and the trained loaders.

Every bf16 convolution runs under the port's own guard of bf16 on the CPU
(``utils/device.py:cpu_bf16_convolutions``, entered by the wrappers), as a
user's bf16 run on the CPU does. Both sides start from one JAX init (or
one vendored checkpoint), cast to bf16 as ``tests/test_torch_dtype.py``
casts them; inputs come from a seed with numpy, rounded to bf16.

* ``stream_chain`` over five small TCNs in bf16 (windows of 16384 samples
  overlapping by 2048, 40000 samples, three windows, every effect on) gives
  the JAX package's bf16 ``stream_chain``: both return fp32 (the
  crossfade's buffers are fp32), bit for bit: both sum each bf16
  convolution in fp32 and round it once, and the small TCNs' sums are short
  enough that the order of the sums does not show.
* ``PipelineChain`` on ``["cpu", "cpu"]`` in bf16 equals ``run`` bit for
  bit, window by window.
* ``sample_windows`` at 4 ranks in bf16: the TCN's halo gives the whole
  file bit for bit; the Mini-DCUNet-6's within 1e-2 x the whole file's
  RMS, a bf16 bound: its windows' frames may round at other offsets than
  the whole file's (measured 0.0 on this input; 3.95e-3 on another, where
  fp32 reads 1.7e-6).
* The trained TCN and ``dcunet_reverb_aug_r4``, read by the port's loader
  (which upcasts the vendored bf16 parameters to fp32, as the JAX loader
  does) and cast to bf16, against the JAX loader's model cast the same
  way, at 16384 samples of a demo clip: within ``TRAINED_TOL`` x the RMS
  of the JAX fp32 output (measured tcn 0.077, dcunet 0.029: ten blocks of
  the trained TCN round in bf16 at other places in the two frameworks);
  and no worse than the reference, as ``tests/test_torch_dtype.py`` holds
  it: the port's bf16 error against its fp32 output at most twice the JAX
  package's against its own plus one bf16 ulp of that RMS (measured, port
  / JAX: tcn 0.062 / 0.069, dcunet 0.020 / 0.038).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remfx_tpu.chain.inference import ChainInference as JaxChain
from remfx_tpu.chain.stream import stream_chain as jax_stream_chain
from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.train.checkpoint import load_trained_wrapper as jax_load_trained_wrapper
from remfx_tpu_torch.chain.inference import DEFAULT_ORDER, ChainInference
from remfx_tpu_torch.chain.pipeline import PipelineChain
from remfx_tpu_torch.chain.stream import stream_chain
from remfx_tpu_torch.compat import from_jax
from remfx_tpu_torch.data.wav import read_wav
from remfx_tpu_torch.models import make_model
from remfx_tpu_torch.parallel.sequence import sample_windows, time_plan
from remfx_tpu_torch.train.checkpoint import load_trained_wrapper

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SR = 48000
BF16 = torch.bfloat16
CHUNK, OVERLAP, T = 16384, 2048, 40000
DCUNET_WINDOWS_TOL = 1e-2  # x the RMS of the whole file's output
TRAINED_TOL = {"tcn_distortion_aug": 0.15, "dcunet_reverb_aug_r4": 0.06}
TCN_SMALL = dict(nblocks=2, channel_width=4, kernel_size=3, dilation_growth=2)


def _bf16_numpy(shape, seed):
    """A seeded numpy signal rounded to bf16 (held as fp32)."""
    x = 0.1 * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(BF16).float().numpy()


def _cast_bf16(variables):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
                        variables)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


@pytest.fixture(scope="module")
def tcn_chains():
    """A small TCN in each of the five slots from one JAX init each: (JAX
    chain, port chain), both in bf16."""
    key = jax.random.PRNGKey(5)
    x1 = jnp.zeros((1, 1, CHUNK))
    jmodels, models = {}, {}
    for i, name in enumerate(DEFAULT_ORDER):
        w = jax_make_model("tcn", **TCN_SMALL)
        variables = jax.device_get(w.init(jax.random.fold_in(key, i), x1))
        jmodels[name] = (w, _cast_bf16(variables))
        port = make_model("tcn", device="cpu", **TCN_SMALL)
        port.module.load_state_dict(from_jax.tcn_state_dict(variables), strict=True)
        models[name] = port.to(BF16)
    return JaxChain(jmodels, SR), ChainInference(models, SR)


def test_bf16_stream_chain_matches_jax(tcn_chains):
    jc, pc = tcn_chains
    x = _bf16_numpy((1, T), seed=2)
    labels = np.ones(5, np.float32)
    yj, lj = jax_stream_chain(jc, jnp.asarray(x, jnp.bfloat16), chunk=CHUNK,
                              overlap=OVERLAP, labels=labels)
    yt, lt = stream_chain(pc, torch.from_numpy(x).to(BF16), chunk=CHUNK,
                          overlap=OVERLAP, labels=labels)
    assert yt.dtype == torch.float32 and np.asarray(yj).dtype == np.float32
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_bf16_pipeline_chain_equals_run_bit_for_bit(tcn_chains):
    _, pc = tcn_chains
    xs = [torch.from_numpy(_bf16_numpy((2, 1, CHUNK), seed=s)).to(BF16) for s in (3, 4, 5)]
    labels = torch.from_numpy(np.random.default_rng(6).integers(0, 2, (2, 5)).astype(np.float32))
    got = PipelineChain(pc, devices=["cpu", "cpu"])(xs, labels)
    for (y, lab), x in zip(got, xs):
        want, want_labels = pc.run(x, labels)
        assert y.dtype == BF16 and torch.equal(y, want) and torch.equal(lab, want_labels)


@pytest.mark.parametrize("name,net,equal", [
    ("tcn", dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2), True),
    ("dcunet", dict(architecture="Mini-DCUNet-6", stft_kernel_size=64), False),
])
def test_bf16_time_windows_at_four_ranks(name, net, equal):
    torch.manual_seed(3)
    w = make_model(name, device="cpu", **net).to(BF16)
    x = torch.from_numpy(_bf16_numpy((1, 1, 30001), seed=4)).to(BF16)
    want = w.sample(x)
    got = sample_windows(w, time_plan(w), x, 4)
    assert got.dtype == BF16 and got.shape == want.shape
    if equal:
        assert torch.equal(got, want)
    else:
        err = (got.float() - want.float()).abs().max() / want.float().pow(2).mean().sqrt()
        assert err.item() <= DCUNET_WINDOWS_TOL


@pytest.mark.parametrize("ckpt", sorted(TRAINED_TOL))
def test_trained_models_cast_to_bf16_match_jax(ckpt):
    x, _ = read_wav(ROOT / "demos" / "example_distortion_reverb.wav")
    x = torch.from_numpy(np.ascontiguousarray(x[None, :1, :16384], np.float32)).to(BF16)
    xf = x.float().numpy()
    _, jw, variables = jax_load_trained_wrapper(ROOT / "ckpts" / ckpt)
    jfn = jax.jit(jw.sample)
    jax_f32 = np.asarray(jfn(variables, jnp.asarray(xf)), np.float64)
    jax_bf16 = np.asarray(jfn(_cast_bf16(variables), jnp.asarray(xf, jnp.bfloat16)),
                          np.float64)
    _, wrapper = load_trained_wrapper(ROOT / "ckpts" / ckpt, device="cpu")
    assert all(p.dtype == torch.float32 for p in wrapper.parameters())  # the upcast
    port_f32 = wrapper.sample(x.float()).double().numpy()
    got = wrapper.to(BF16).sample(x)
    assert got.dtype == BF16 and got.shape == jax_bf16.shape
    got = got.double().numpy()
    rms = _rms(jax_f32)
    assert np.abs(got - jax_bf16).max() <= TRAINED_TOL[ckpt] * rms
    ulp = 2.0 ** (np.floor(np.log2(rms)) - 7)
    assert np.abs(got - port_f32).max() <= 2 * np.abs(jax_bf16 - jax_f32).max() + ulp
