"""perfbench/flops.py against hand counts: 2 operations a multiply-add."""

import torch
from torch import nn

from perfbench import flops
from perfbench.reference.hdemucs import LocalState


def _count(module, *inputs, passes=1):
    module = module.to("meta")
    inputs = [torch.empty(s, device="meta") for s in inputs]
    with torch.no_grad():
        return flops._count(module, lambda: module(*inputs), passes)


def test_conv1d():
    b, cin, cout, k, t = 3, 4, 6, 5, 50
    assert _count(nn.Conv1d(cin, cout, k), (b, cin, t)) == 2 * b * cout * cin * k * (t - k + 1)


def test_conv_transpose1d():
    b, cin, cout, k, t, s = 3, 4, 6, 8, 50, 4
    assert _count(nn.ConvTranspose1d(cin, cout, k, s), (b, cin, t)) == 2 * b * cin * cout * k * t


def test_lstm_layer():
    """One bidirectional layer: per step and direction four gates, each a
    product with the input and one with the hidden state."""
    t, b, i, h = 7, 3, 6, 5
    lstm = nn.LSTM(i, h, num_layers=1, bidirectional=True)
    hand = 2 * t * b * 4 * 2 * h * (i + h)
    assert flops.lstm_flops(lstm, t, b) == hand
    assert _count(lstm, (t, b, i)) == hand
    with torch.no_grad():  # torch's own count of the unrolled layer agrees
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as counter:
            nn.LSTM(i, h, bidirectional=True).to("meta")(torch.empty(t, b, i, device="meta"))
    assert counter.get_total_flops() == hand


def test_local_state_attention():
    """HDemucs' LocalState: content, query, key and projection 1x1
    convolutions, the decay queries, the dot products, the decay term and
    the weighted sum."""
    b, c, t, heads, ndecay = 2, 8, 16, 4, 4
    hand = b * (4 * 2 * c * c * t + 2 * c * heads * ndecay * t
                + 2 * (2 * heads * (c // heads) * t * t) + 2 * heads * ndecay * t * t)
    assert _count(LocalState(c, heads=heads, ndecay=ndecay), (b, c, t)) == hand


def test_training_counts_the_lstm_three_times():
    lstm = nn.LSTM(6, 5).to("meta")
    x = torch.empty(4, 2, 6, device="meta", requires_grad=True)
    n = flops._count(lstm, lambda: lstm(x)[0].sum(), passes=3)
    assert n == 3 * flops.lstm_flops(lstm, 4, 2)
