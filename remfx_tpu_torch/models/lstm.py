"""LSTM / BiLSTM over ``(T, B, F)`` sequences.

Counterpart of ``remfx_tpu/models/lstm.py``. The JAX module keeps
torch's parameterisation on purpose (``weight_ih_l{n}[_reverse]``,
``weight_hh_*``, ``bias_ih_*``, ``bias_hh_*``, gate order i, f, g, o,
zero initial state), so here it is ``torch.nn.LSTM`` itself, returning
only the output sequence. ``dropout`` is torch's (and the JAX module's):
on the outputs of every layer but the last, in train mode only. A call
is the span ``lstm`` (``utils/spans.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from remfx_tpu_torch.utils.spans import span


class LSTM(nn.LSTM):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (T, B, input_size) -> (T, B, hidden_size * directions)."""
        with span("lstm"):
            return super().forward(x)[0]
