"""The benchmark's plain reference, in fp32 PyTorch with TF32 off.

It imports nothing of the program and takes nothing the program made:
the benchmark hands it the same seeded state dicts and inputs, and it
works out the chain's row sets and the training step's state itself.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 matrix products and convolutions with TF32 ``tf32``; the flags
    as they were afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp32_exact():
    return precision(tf32=False)
