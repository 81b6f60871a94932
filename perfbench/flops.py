"""Useful floating-point operations of a cell's work, counted on the
reference models over meta tensors with ``torch.utils.flop_counter``.

Counted: every convolution and transposed convolution (forward and both
gradients), every matrix product (linear layers, the attention's einsums,
the mel filterbank's product), and the LSTMs' gate products, 2 operations
a multiply-add. Not counted: FFTs, elementwise operations, norms, softmax.
An LSTM on meta tensors would unroll into thousands of small operations,
so it is counted from its sizes (``lstm_flops``; the backward pass twice
the forward) and stands in as an empty output of its shape. Because the
count is taken on the reference, the work reads the same whatever
implements it.
"""

from __future__ import annotations

import types

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import models
from perfbench.reference.train import removal_loss


def lstm_flops(lstm: nn.LSTM, steps: int, batch: int) -> int:
    """The four gates' products with the input and the hidden state, in
    every layer and direction, at every step of every sequence."""
    d, h = 2 if lstm.bidirectional else 1, lstm.hidden_size
    per_step = sum(d * 2 * 4 * h * ((lstm.input_size if layer == 0 else d * h) + h)
                   for layer in range(lstm.num_layers))
    return per_step * steps * batch


def _count(model: nn.Module, fn, passes: int) -> int:
    """``fn()``'s counted operations, each LSTM of ``model`` counted
    ``passes`` times from its sizes."""
    lstm_total = [0]

    def stand_in(self, x, hx=None):
        steps, batch = (x.shape[1], x.shape[0]) if self.batch_first else x.shape[:2]
        lstm_total[0] += passes * lstm_flops(self, steps, batch)
        d = 2 if self.bidirectional else 1
        out = x.new_empty(*x.shape[:2], d * self.hidden_size)
        state = x.new_empty(d * self.num_layers, batch, self.hidden_size)
        return out, (state, state)

    for m in model.modules():
        if isinstance(m, nn.LSTM):
            m.forward = types.MethodType(stand_in, m)
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops()) + lstm_total[0]


def forward_flops(entry: dict, rows: int, samples: int) -> int:
    """One forward pass of the entry's model over (rows, 1, samples)."""
    with torch.device("meta"):
        model = models.build(entry).eval()
    x = torch.empty(rows, 1, samples, device="meta")
    with torch.no_grad():
        return _count(model, lambda: model(x), passes=1)


def train_step_flops(entry: dict, rows: int, samples: int) -> int:
    """Forward, removal loss and backward of the entry's model over
    (rows, 1, samples)."""
    with torch.device("meta"):
        model = models.build(entry).train()
    x = torch.empty(rows, 1, samples, device="meta")
    y = torch.empty(rows, 1, samples, device="meta")
    return _count(model, lambda: removal_loss(model(x), y).backward(), passes=3)
