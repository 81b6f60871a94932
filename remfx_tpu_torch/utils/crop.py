"""Cropping helpers shared by models and the chain.

Counterpart of ``remfx_tpu/utils/crop.py``, with the same slicing,
including the deliberate off-by-one of ``causal_crop`` (reference
remfx/utils.py:202-211): the final sample is *excluded*, i.e. the crop
takes ``x[..., L-1-length : L-1]``.
"""


def center_crop(x, length: int):
    """Crop the trailing axis to ``length`` samples, centered."""
    start = (x.shape[-1] - length) // 2
    return x[..., start : start + length]


def causal_crop(x, length: int):
    """Crop the trailing axis to the last ``length`` samples excluding the
    very last sample (reference remfx/utils.py:208-211 — part of the spec)."""
    stop = x.shape[-1] - 1
    start = stop - length
    return x[..., start:stop]
