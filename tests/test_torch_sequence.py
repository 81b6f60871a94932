"""Sequence-parallel inference of the port (``remfx_tpu_torch/parallel/
sequence.py``, ``parallel.shard_time``) against the JAX package's
``shard_time`` (``tests/test_parallel.py``) and against one process.

The port runs one process per device: here 2 or 4 gloo ranks on the CPU,
started by ``parallel.launch.spawn`` (one thread a rank), each with a
join deadline; every rank also runs the whole input itself, the
one-process reference. The JAX side runs on the conftest's 8 virtual CPU
devices.

* Against JAX: the setup of ``test_sequence_parallel_inference_exact``
  (TCN 4 x 8, kernel 7, dilation growth 2; Mini-DCUNet-6 at stft kernel
  64; 1 x 1 x 32768, here from a numpy seed; weights from JAX's init
  through ``compat/from_jax.py``): the gathered ``sample_time_sharded``
  within the parity tolerances of ``tests/test_torch_tcn.py`` (1e-5
  absolute) and ``tests/test_torch_dcunet.py`` (1e-4 x the JAX output's
  RMS).
* Against one process: the halo plans (TCN, DCUNet) within 1e-6 absolute,
  JAX's own bound, also at a ragged length (30001: not divisible by 2 or
  4, not a multiple of the DCUNet's 64-sample alignment); the gather
  plans (HDemucs at nfft 64, channels 8, depth 2, as
  ``__graft_entry__.py``; a small UMX; a small DPTNet) bit for bit.
* ``run_time_sharded`` over a small five-slot chain (that TCN, the
  HDemucs, three Mini-DCUNet-6 with identity_init; a full-width Cnn14 to
  detect) against ``ChainInference.remove`` / ``run`` of the whole input:
  oracle labels, detection, ``use_all_effect_models``, mixed labels, every
  row off for the TCN and HDemucs (their stages skipped), and a file the
  TCN shortens so far that the last rank's span is empty; 1e-6 absolute,
  the labels equal.
* A DCUNet halo forced to 0 fails the comparison on random data (so the
  tolerance catches a wrong reach); the DCUNet's windows run inference's
  epilogues and equal the whole file's forward that autograd records; the
  contract's error paths.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from remfx_tpu.models import make_model as jax_make_model
from remfx_tpu.parallel import make_mesh as jax_make_mesh
from remfx_tpu.parallel import replicate as jax_replicate
from remfx_tpu.parallel import shard_time as jax_shard_time
from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.compat.from_jax import dcunet_state_dict, tcn_state_dict
from remfx_tpu_torch.models import make_model
from remfx_tpu_torch.models import dcunet as dcunet_module
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.ops.dcunet_epilogue import dcunet_epilogue
from remfx_tpu_torch.parallel import TimeShard, launch
from remfx_tpu_torch.parallel.sequence import (PLANS, GatherPlan, HaloPlan, sample_windows,
                                               span_sample, time_plan)
from remfx_tpu_torch.parallel.steps import (time_shard_contract, time_sharded_chain,
                                            time_sharded_samples)

torch.set_num_threads(2)
JOIN_S = 240  # deadline of a launch's join
T = 32768
RAGGED = 30001
TCN_NET = dict(nblocks=4, channel_width=8, kernel_size=7, dilation_growth=2)  # rf 91
DCUNET_NET = dict(architecture="Mini-DCUNet-6", stft_kernel_size=64)
DEMUCS_NET = dict(sources=["mixture"], audio_channels=1, nfft=64, channels=8, depth=2)
UMX_NET = dict(n_fft=512, hop_length=256, hidden_size=64)
DPTNET_NET = dict(chunk_size=20, n_repeats=1)
HALO_TOL = 1e-6
RANKS = (2, 4)
# a file the TCN (rf 91) shortens to at most the last rank's start: n =
# 2: 181 -> 91 samples, rank 1's span [91, 91); n = 4: 361 -> 271, rank
# 3's span [271, 271). On 4 ranks its 91-sample spans are shorter than a
# Mini-DCUNet-6's halo (384), so only the TCN runs it there.
EMPTY_T = {2: 181, 4: 361}
# (model index, samples) of each time-sharded sample
HALO_CASES = [(0, T), (1, T), (0, RAGGED), (1, RAGGED)]
GATHER_CASES = [(2, T), (3, T), (4, T)]
NAMES = ["tcn", "dcunet", "demucs", "umx", "dptnet"]


def _rms_err(got, want):
    return np.abs(got - want).max() / np.sqrt(np.mean(want ** 2))


@pytest.fixture(scope="module")
def jax_side():
    """The input, JAX's time-sharded ``sample`` on 8 devices, and the
    port's state dicts of the same weights."""
    x = (0.1 * np.random.default_rng(0).standard_normal((1, 1, T))).astype(np.float32)
    mesh = jax_make_mesh(dp=8, tp=1)
    xs = jax_shard_time(x, mesh)
    out = {}
    for name, cfg, convert in (("tcn", TCN_NET, tcn_state_dict),
                               ("dcunet", DCUNET_NET, dcunet_state_dict)):
        w = jax_make_model(name, **cfg)
        v = w.init(jax.random.PRNGKey(1), x)
        y_sp = jax.jit(lambda v, x, w=w: w.sample(v, x))(jax_replicate(v, mesh), xs)
        sd = {k: t.numpy() for k, t in convert(jax.device_get(v)).items()}
        out[name] = (np.asarray(y_sp), sd)
    return x, out


def _models(jax_side):
    _, by_name = jax_side
    return [("tcn", TCN_NET, by_name["tcn"][1]), ("dcunet", DCUNET_NET, by_name["dcunet"][1]),
            ("demucs", DEMUCS_NET, None), ("umx", UMX_NET, None), ("dptnet", DPTNET_NET, None)]


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def samples(request, jax_side):
    """-> (n, the cases, each rank's results)."""
    n = request.param
    x, _ = jax_side
    cases = HALO_CASES + GATHER_CASES + [(0, EMPTY_T[n])]
    ranks = launch.spawn(time_sharded_samples, n, _models(jax_side), x, cases,
                         device_type="cpu", timeout=JOIN_S)
    return n, cases, ranks


def test_halo_plans_match_jax_shard_time(samples, jax_side):
    _, cases, ranks = samples
    for name, i in (("tcn", 0), ("dcunet", 1)):
        want = jax_side[1][name][0]
        got = ranks[0][cases.index((i, T))]["sharded"]
        assert got.shape == want.shape
        if name == "tcn":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert _rms_err(got, want) <= 1e-4


@pytest.mark.parametrize("case", HALO_CASES, ids=lambda c: f"{NAMES[c[0]]}-{c[1]}")
def test_halo_plans_equal_one_process(samples, case):
    _, cases, ranks = samples
    for rank in ranks:
        r = rank[cases.index(case)]
        assert r["sharded"].shape == r["whole"].shape
        np.testing.assert_allclose(r["sharded"], r["whole"], atol=HALO_TOL, rtol=0)


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: NAMES[c[0]])
def test_gather_plans_equal_one_process_bit_for_bit(samples, case):
    _, cases, ranks = samples
    for rank in ranks:
        r = rank[cases.index(case)]
        np.testing.assert_array_equal(r["sharded"], r["whole"])


def test_spans_lie_on_the_output_grid(samples):
    """ceil(T / n) samples each over the input; the TCN's output (90
    samples shorter) keeps the grid, its last span shorter."""
    n, cases, ranks = samples
    for T_in in (T, RAGGED):
        step = -(-T_in // n)
        for i, rank in enumerate(ranks):
            assert rank[cases.index((1, T_in))]["span"] == [i * step, min((i + 1) * step, T_in)]
            assert rank[cases.index((0, T_in))]["span"] == [
                min(i * step, T_in - 90), min((i + 1) * step, T_in - 90)]


def test_tcn_leaves_the_last_rank_an_empty_span(samples):
    n, cases, ranks = samples
    T_in = EMPTY_T[n]
    results = [rank[cases.index((0, T_in))] for rank in ranks]
    assert results[-1]["span"] == [T_in - 90, T_in - 90]
    for r in results:
        assert r["sharded"].shape == (1, 1, T_in - 90)
        np.testing.assert_allclose(r["sharded"], r["whole"], atol=HALO_TOL, rtol=0)


# ------------------------------------------------------------ the chain

SLOTS = {"RandomPedalboardDistortion": ("tcn", TCN_NET, None),
         "RandomPedalboardCompressor": ("demucs", DEMUCS_NET, None),
         **{k: ("dcunet", {**DCUNET_NET, "identity_init": True}, None)
            for k in ("RandomPedalboardReverb", "RandomPedalboardChorus",
                      "RandomPedalboardDelay")}}
CHAIN_T = 6007  # B = 2 rows; after the TCN 5917 samples


def _labels(on_rows):
    return np.array([[float(e in row) for e in ALL_EFFECTS] for row in on_rows], np.float32)


CHAIN_CASES = {
    "oracle": _labels([ALL_EFFECTS] * 2),
    "detect": "detect",
    "all": "all",
    "mixed": _labels([("distortion", "reverb", "delay"), ("compressor", "chorus")]),
    "skip_tcn_and_demucs": _labels([("reverb",), ("chorus", "delay")]),
}


@pytest.fixture(scope="module")
def chain_runs():
    """-> {n: ({case: result} of rank 0, every rank's results)}."""
    rng = np.random.default_rng(7)
    x = (0.1 * rng.standard_normal((2, 1, CHAIN_T))).astype(np.float32)
    small = (0.1 * rng.standard_normal((1, 1, EMPTY_T[2]))).astype(np.float32)
    out = {}
    for n in RANKS:
        names = list(CHAIN_CASES)
        cases = [(x, labels) for labels in CHAIN_CASES.values()]
        if n == 2:
            names.append("empty_last_rank")
            cases.append((small, _labels([ALL_EFFECTS])))
        ranks = launch.spawn(time_sharded_chain, n, SLOTS, cases, {"num_classes": 5},
                             device_type="cpu", timeout=JOIN_S)
        out[n] = (names, ranks)
    return out


@pytest.mark.parametrize("n,case", [(n, c) for n in RANKS for c in CHAIN_CASES]
                         + [(2, "empty_last_rank")], ids=lambda v: str(v))
def test_run_time_sharded_equals_the_whole_chain(chain_runs, n, case):
    names, ranks = chain_runs[n]
    for rank in ranks:
        r = rank[names.index(case)]
        np.testing.assert_array_equal(r["labels"], r["whole_labels"])
        assert r["sharded"].shape == r["whole"].shape
        np.testing.assert_allclose(r["sharded"], r["whole"], atol=HALO_TOL, rtol=0)
    if case == "empty_last_rank":
        T_out = EMPTY_T[n] - 90
        assert ranks[-1][names.index(case)]["span"] == [T_out, T_out]


# ------------------------------------------------------------ plans, power, contract

def _dcunet_pair():
    torch.manual_seed(3)
    w = make_model("dcunet", device="cpu", **DCUNET_NET)
    x = 0.1 * torch.randn(1, 1, RAGGED, generator=torch.Generator().manual_seed(4))
    return w, x


@pytest.mark.parametrize("ranks", RANKS)
def test_dcunet_windows_equal_the_whole_file_and_a_zero_halo_does_not(ranks):
    """The plan's windows, run one after another in this process, equal the
    whole file within the halo tolerance; the same windows with the halo
    forced to 0 miss it by orders of magnitude (the reach matters)."""
    w, x = _dcunet_pair()
    plan = time_plan(w)
    want = w.sample(x)
    got = sample_windows(w, plan, x, ranks)
    assert (got - want).abs().max().item() <= HALO_TOL
    blind = sample_windows(w, HaloPlan(0, 0, plan.align), x, ranks)
    assert (blind - want).abs().max().item() > 1e3 * HALO_TOL


@pytest.mark.parametrize("ranks", RANKS)
def test_dcunet_windows_take_the_packed_path(ranks, monkeypatch):
    """The plan's windows of a Mini-DCUNet-6 in eval run inference (7
    epilogues a window, kept weights) and equal the whole file's eval
    forward that autograd records (weights built in the graph) within the
    halo tolerance."""
    w, x = _dcunet_pair()
    want = w(x).detach()
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return dcunet_epilogue(*args, **kwargs)

    monkeypatch.setattr(dcunet_module, "dcunet_epilogue", counted)
    got = sample_windows(w, time_plan(w), x, ranks)
    assert len(calls) == 7 * ranks
    assert (got - want).abs().max().item() <= HALO_TOL


def test_time_plan_table():
    tcn = make_model("tcn", device="cpu", **TCN_NET)
    assert time_plan(tcn) == HaloPlan(0, 90, 1)
    assert time_plan(DCUNet("Mini-DCUNet-6", 64)) == HaloPlan(384, 384, 64)
    # Large-DCUNet-20 at K = 512: 102 frames of reach, plus two, at hop 256
    assert time_plan(DCUNet("Large-DCUNet-20", 512)) == HaloPlan(26624, 26624, 4096)
    gathered = {"HDemucs", "UMXSeparator", "DPTNet", "Cnn14", "EmbeddingClassifier"}
    assert {t.__name__ for t in PLANS} == gathered | {"TCN", "DCUNet"}
    for t, make in PLANS.items():
        if t.__name__ in gathered:
            assert isinstance(make(None), GatherPlan) and make(None).why


def test_unlisted_module_raises_type_error():
    with pytest.raises(TypeError, match="no time plan for Conv1d"):
        time_plan(ModelWrapper(nn.Conv1d(1, 1, 3)))
    with pytest.raises(TypeError, match="no time plan for Linear"):
        time_plan(nn.Linear(4, 4))


def test_span_sample_refuses_a_window_off_the_plan():
    w, x = _dcunet_pair()
    plan = time_plan(w)
    keep = (8192, 16384)
    a, b = plan.window(RAGGED, keep)
    shifted = TimeShard(x[..., a + 32:b], a + 32, b, RAGGED, 8192, 1, 4)
    with pytest.raises(ValueError, match="not the plan's"):
        span_sample(w, plan, shifted, keep)


@pytest.fixture(scope="module")
def contract():
    return launch.spawn(time_shard_contract, 4, device_type="cpu", timeout=JOIN_S)


def test_shard_time_accepts_nested_lists_and_splits_over_dp_only(contract):
    """``test_shard_time_accepts_non_arrays``' counterpart on a (dp 2, tp 2)
    mesh: the two tp ranks of a dp coordinate hold the same span."""
    for r in contract:
        assert r["shape"] == [1, 1, 16]
        assert r["whole"] == [[list(range(16))]]
        start = 8 * r["dp_rank"]
        assert r["span"] == [start, start + 8]
        assert r["data"] == [[list(range(start, start + 8))]]
    assert [(r["dp_rank"], r["tp_rank"]) for r in contract] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_halo_past_the_adjacent_span_raises(contract):
    for r in contract:
        assert len(r["errors"]) == 2
        assert all("reaches past rank" in e for e in r["errors"])
