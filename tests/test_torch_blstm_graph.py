"""HDemucs's BLSTM and its CUDA graph (``models/demucs.py``) on the CPU.

``graph_engages``, the rule that sends a call to the graph, over all its
cases. On the CPU the block runs eagerly in every mode, bit for bit the
oracle block of ``tests/_torch_hdemucs.py`` with the same weights, and
counts nothing. The graph cache's keys are reached with the rule forced
on: a key's first call runs eagerly and never touches the card, so the
bookkeeping (a key a shape, dtype, device and set of parameter pointers;
the least recently used key dropped; ``train(True)`` and a copy starting
with none) is tested here, and the captures and replays on the card
(``tests/test_torch_cuda.py``). Last, the benchmark's reader of the
counters.
"""

import copy
import itertools

import pytest
import torch
from torch import nn

from perfbench import harness
from remfx_tpu_torch.models import demucs
from remfx_tpu_torch.models.demucs import BLSTM, HDemucs
from tests._torch_hdemucs import BLSTM as OracleBLSTM

torch.set_num_threads(2)
DIM = 8
COUNTERS = ("card_calls", "graph_captures", "graph_replays")


@pytest.fixture
def counters(monkeypatch):
    for name in COUNTERS:
        monkeypatch.setattr(BLSTM, name, 0)
    return lambda: tuple(getattr(BLSTM, name) for name in COUNTERS)


@pytest.fixture
def forced(monkeypatch):
    """The rule forced on: calls on the CPU take the graph path's keys."""
    monkeypatch.setattr(demucs, "graph_engages", lambda *case: True)


def _block(seed=0):
    torch.manual_seed(seed)
    return BLSTM(DIM)


def _x(T, rows=2, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, DIM, T, generator=g).to(dtype)


@pytest.mark.parametrize("is_cuda,grad,training,capturing",
                         list(itertools.product([False, True], repeat=4)))
def test_graph_engages_only_in_inference_on_the_card_outside_a_capture(is_cuda, grad,
                                                                        training, capturing):
    want = is_cuda and not grad and not training and not capturing
    assert demucs.graph_engages(is_cuda, grad, training, capturing) is want


@pytest.mark.parametrize("T", [150, 450], ids=["one_frame", "framed"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_blstm_on_the_cpu_runs_eagerly_bit_for_bit_and_counts_nothing(counters, T, training,
                                                                      grad):
    """The dropout is 0, so train mode computes what eval does."""
    block = _block().train(training)
    oracle = OracleBLSTM(DIM, layers=2, max_steps=200, skip=True).train(training)
    oracle.load_state_dict(block.state_dict(), strict=True)
    x = _x(T)
    with torch.set_grad_enabled(grad):
        got, want = block(x), oracle(x)
    assert torch.equal(got, want)
    assert counters() == (0, 0, 0)
    assert not block._graphs


def test_a_keys_first_call_runs_eagerly_and_keeps_its_key(counters, forced):
    block = _block().eval()
    x = _x(250)
    with torch.no_grad():
        got = block(x)
        assert torch.equal(got, block._stitched(x) + x)
    assert counters() == (1, 0, 0)
    (key,) = block._graphs
    assert block._graphs[key] is None
    assert key[:3] == ((2, DIM, 250), torch.float32, torch.device("cpu"))
    assert key[3] == tuple(p.data_ptr() for p in block.parameters())


def test_train_mode_drops_the_graph_cache(forced):
    block = _block().eval()
    parent = nn.Sequential(block)
    with torch.no_grad():
        block(_x(100))
        block(_x(300))
    assert len(block._graphs) == 2
    parent.eval()
    assert len(block._graphs) == 2
    parent.train()  # reaches the block as HDemucs's train() does
    assert not block._graphs


def test_a_changed_parameter_pointer_is_a_new_key(forced):
    block = _block().eval()
    x = _x(120)
    state = {k: v.clone() for k, v in block.state_dict().items()}
    with torch.no_grad():
        block(x)
        pointers = block._pointers()
        block.load_state_dict(state)  # copied into the same storage: the same key
        assert block._pointers() == pointers
        block.load_state_dict(state, assign=True)  # new tensors: a new key
        block(x)
        assert len(block._graphs) == 2
        block.to(torch.float64)
        block(x.double())
    keys = list(block._graphs)
    assert len(keys) == 3
    assert keys[0][:3] == keys[1][:3] and keys[0][3] != keys[1][3]
    assert keys[2][1] == torch.float64


def test_the_cache_keeps_the_most_recent_keys(forced):
    block = _block().eval()
    lengths = [100 + 10 * k for k in range(BLSTM.graph_keys + 2)]
    with torch.no_grad():
        for T in lengths:
            block(_x(T))
    assert [key[0][-1] for key in block._graphs] == lengths[-BLSTM.graph_keys:]


def test_a_copy_starts_with_no_graphs(forced):
    block = _block().eval()
    with torch.no_grad():
        block(_x(100))
    twin = copy.deepcopy(block)
    assert len(block._graphs) == 1 and not twin._graphs
    assert all(torch.equal(a, b) for a, b in zip(block.state_dict().values(),
                                                  twin.state_dict().values()))


def test_hdemucs_on_the_cpu_counts_no_card_call(counters):
    torch.manual_seed(0)
    model = HDemucs(sources=("mixture",), audio_channels=1, channels=8, nfft=64, depth=3,
                    norm_starts=1, dconv_lstm=2, dconv_attn=1).eval()
    with torch.no_grad():
        model(0.1 * torch.randn(1, 1, 4096))
    assert counters() == (0, 0, 0)
    assert all(not m._graphs for m in model.modules() if isinstance(m, BLSTM))


class _Run:
    """What the reader is handed; it reads the counters alone."""


@pytest.mark.parametrize("calls,replays,want", [(0, 0, None), (120, 112, 100.0 * 112 / 120),
                                                (8, 8, 100.0)])
def test_graphed_share_reader(monkeypatch, calls, replays, want):
    monkeypatch.setattr(BLSTM, "card_calls", calls)
    monkeypatch.setattr(BLSTM, "graph_replays", replays)
    got = harness.read_metric("blstm_graphed_pct.chain", _Run())
    assert got == (None if want is None else pytest.approx(want))
