"""Of HDemucs's BLSTM calls in inference on the card, the share in percent
that replayed a CUDA graph: the port's counters ``BLSTM.graph_replays``
over ``BLSTM.card_calls`` (``models/demucs.py``). They count over the
process, set-up's batches too; a key's first call runs eagerly and its
second captures and replays. None where the program has no such counters
or made no such call."""


def read(run):
    from remfx_tpu_torch.models.demucs import BLSTM

    calls = getattr(BLSTM, "card_calls", 0)
    if not calls:
        return None
    return 100.0 * BLSTM.graph_replays / calls
