"""Named spans of the port for ``torch.profiler``, and the port's counters.

``span(name)`` is ``torch.profiler.record_function(name)`` while the
profiler records: the span is then a ``user_annotation`` in its trace, on
the clock of the card's kernel, copy and fill records, so that a kernel
and an idle gap of the card can be put down to the span its host work ran
in. With no profiler recording it is one shared no-op context, at the
cost of reading the profiler's flag (``record_function`` itself costs
about a hundred times more even with no profiler on). The spans land in
whatever trace is running: the benchmark's traced run, or ``fit``'s
chrome trace under the ``profile`` key (``train/loop.py``). The names
are fixed and dotted; none starts with ``detect``, ``remove``, ``d2h``,
``h2d``, ``step``, ``autograd::`` or ``Optimizer.``, the ranges that the
benchmark and torch record themselves.

Spans, outermost first:

``chain.detect``
    ``ChainInference.detect``: the classifier and its threshold.
``chain.counts``
    the regroup dispatch's one host readback of the label counts.
``chain.stage.<effect> n=<n> b=<bucket>``
    a stage of the regroup dispatch: ``n`` rows selected, the model run
    on a sub-batch of ``bucket`` rows; ``b=dense`` for the masked stage
    over the whole batch, ``b=skip`` (``n=0``) for the passthrough's crop.
``chain.stage.<effect>``
    a stage of the masked dispatch modes, which read no counts.
``model.<name>``
    ``ModelWrapper.forward`` (``model.demucs``, ``model.dcunet``,
    ``model.tcn``, ``model.umx``, ``model.dptnet``).
``loss``
    ``removal_loss`` in ``ModelWrapper.loss_and_output``.
``dptnet.intra``, ``dptnet.inter``
    ``models/dptnet.py:DPTNet.forward``: an intra-chunk (sequences of a
    chunk's positions) or inter-chunk (sequences of a position's chunks)
    ``ImprovedTransformerLayer`` with the reshapes around it, inside
    ``model.dptnet``.
``dptnet.mha``
    the multi-head attention of an ``ImprovedTransformerLayer``, inside
    ``dptnet.intra`` or ``dptnet.inter``.
``lstm``
    ``models/lstm.py:LSTM.forward``; in HDemucs's inference on the card,
    a ``models/demucs.py:BLSTM`` call that replays its CUDA graph (the
    input's copy, the replay and the residual add): the LSTM's kernels run
    inside the graph, where no span records.
``groupnorm``
    ``ops/group_norm.py:group_norm``: a GroupNorm of HDemucs with the
    activation it takes (and a DConv's LayerScale and residual add), the
    fused kernel on the card, torch's composition on the CPU; its backward
    pass runs outside it.
``train.step``
    ``RemovalTask.train_step``, the four spans below inside it, so that
    the host work between them (``wrapper.train()``, the contexts around
    the loss) is named too.
``train.forward``
    ``RemovalTask``'s ``loss_and_output`` in a training step, with
    ``model.*`` and ``loss`` inside it.
``train.backward``
    its backward pass. Autograd launches the pass's kernels from its own
    thread, so this span names the main thread's wait, not the kernels.
``train.update``
    ``_apply_gradients``: accumulation, the clip, AdamW (torch's own
    ``Optimizer.step#AdamW.step`` inside it) and the schedule.
``train.clip``
    ``clip_by_global_norm_`` inside ``train.update``.
``train.metrics``
    ``RemovalTask``'s metrics of the step.

Counters, plain process-wide ints bumped on the host and never synced:

``ChainInference.regroup_rows``
    rows the removal models ran in the regroup dispatch: a stage's
    bucket, or the whole batch for the dense masked stage.
``ChainInference.regroup_unselected``
    rows among those that no label selected: ``bucket - n``, or ``B - n``.
``envelope.launches``, ``envelope_serial.launches`` (``ops/envelope.py``),
``phaser.launches``, ``phaser_serial.launches`` (``ops/phaser.py``),
``group_norm.launches`` (``ops/group_norm.py``)
    calls of the hand-written kernels.
``BLSTM.card_calls``, ``BLSTM.graph_captures``, ``BLSTM.graph_replays`` (``models/demucs.py``)
    HDemucs's BLSTM calls that satisfy ``graph_engages`` (inference on the
    card outside a capture), the CUDA graphs captured, and the replays
    (a key's first call runs eagerly, its second captures and replays).
``dcunet_epilogue.launches`` (``ops/dcunet_epilogue.py``)
    launches of the DCUNet's eval epilogue kernel on the card: one a
    normed block of an inference, 19 a Large-DCUNet-20 forward; none in
    train mode, and none on the CPU, where its plain version runs.
"""

from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context named ``name`` in the running profiler's trace; a shared
    no-op context when no profiler records."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF
