"""Host-side sub-batch sizes for the chain's regroup dispatch.

Counterpart of ``remfx_tpu/utils/regroup.py``, as it is: a removal stage
whose label is on for only some rows can run its model on a compact
sub-batch of just those rows (gathered, then scattered back) instead of
on the whole batch under a mask. The granularity of 8 and the dense
fraction 0.75 are the JAX package's; they decide which rows take the
sub-batch path, so they are kept.
"""

from __future__ import annotations

import numpy as np


def bucket_size(n: int, max_size: int, granularity: int = 8,
                dense_frac: float = 0.75) -> int | None:
    """Sub-batch size for ``n`` selected of ``max_size`` rows: ``n``
    rounded up to a multiple of ``granularity``, or ``None`` (run the
    dense masked stage) when ``n > dense_frac * max_size`` or the bucket
    reaches the whole batch."""
    if n <= 0:
        raise ValueError("empty selection")
    if n > dense_frac * max_size:
        return None
    g = max(1, int(granularity))
    bucket = -(-int(n) // g) * g
    if bucket >= int(max_size):
        return None  # gathering the whole batch is pure overhead
    return bucket


def bucketed_indices(sel: np.ndarray, max_size: int | None = None) -> np.ndarray:
    """sel: sorted 1-D indices of selected rows (non-empty) -> gather
    indices padded to the next power of two (capped at ``max_size``) by
    repeating the last one."""
    n = int(sel.size)
    if n == 0:
        raise ValueError("empty selection")
    bucket = 1 << (n - 1).bit_length()
    if max_size is not None:
        bucket = min(bucket, int(max_size))
    pad = bucket - n
    if pad <= 0:
        return sel
    return np.concatenate([sel, np.repeat(sel[-1:], pad)])
