"""Device choice for the port's entry points.

Entry points run on the card unless the caller names another device
(the tests pass ``device="cpu"``); asking for the card where there is none
raises, so that nothing falls back to the CPU unasked. On CUDA, TF32 is switched off for
matrix products and for cuDNN (convolutions and RNNs): TF32 keeps about
three decimal digits, so a TF32 convolution would differ from the CPU
and from the JAX reference at the 1e-3 level. The switch is global to
the process, as PyTorch's flags are.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; on CUDA, full-fp32 matmuls and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
