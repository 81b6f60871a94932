"""Device choice for the port's entry points, and its guard of bf16
convolutions on the CPU.

Entry points run on the card unless the caller names another device
(the tests pass ``device="cpu"``); asking for the card where there is none
raises, so that nothing falls back to the CPU unasked. On CUDA, TF32 is switched off for
matrix products and for cuDNN (convolutions and RNNs): TF32 keeps about
three decimal digits, so a TF32 convolution would differ from the CPU
and from the JAX reference at the 1e-3 level. The switch is global to
the process, as PyTorch's flags are.

``cpu_bf16_convolutions`` keeps bf16 convolutions on the CPU off oneDNN,
which computes some of them wrong on a CPU with AMX (torch 2.13.0+cpu:
``F.conv1d`` of 16 to 16 channels, kernel 8, stride 4, is about its
output's norm off the fp32 sums of its bf16 operands). Under it, a bf16
convolution of CPU tensors computes what a sound bf16 kernel computes,
cuDNN's on the card and XLA's on the CPU: the bf16 operands' products and
sums in fp32, the result rounded to bf16 once; its gradients likewise,
where the backward pass runs under the guard too. torch's own CPU kernels
are right too but take minutes on a Large-DCUNet-20, so oneDNN stays on
for the process. The port enters the guard at its choke points (the
removal wrappers' ``forward``, the classifiers' trunk, ``RemovalTask``'s
loss with its backward pass, the recomputation of the TCN's checkpointed
blocks); for CUDA tensors and for fp32 it enters nothing.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# every convolution and transposed convolution, in any dimension, and its
# gradients
_CONVOLUTIONS = frozenset({torch.ops.aten.convolution.default,
                           torch.ops.aten.convolution_backward.default})
_active = threading.local()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; on CUDA, full-fp32 matmuls and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class _Fp32SumConvolutions(TorchDispatchMode):
    """bf16 convolutions of CPU tensors, and their gradients, as fp32 sums of
    the bf16 operands rounded to bf16 once; every other op as it comes. It
    works below autograd, on the ops that every convolution reaches, so
    layers, hooks and function modes still see bf16 in and out."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _CONVOLUTIONS or args[0].dtype != torch.bfloat16 \
                or args[0].device.type != "cpu":
            return func(*args, **kwargs)

        def up(a):
            return a.float() if isinstance(a, torch.Tensor) else a

        out = func(*map(up, args), **{k: up(v) for k, v in kwargs.items()})
        if isinstance(out, torch.Tensor):
            return out.to(torch.bfloat16)
        return tuple(None if o is None else o.to(torch.bfloat16) for o in out)


@contextlib.contextmanager
def _guarded():
    _active.depth = getattr(_active, "depth", 0) + 1
    try:
        with _Fp32SumConvolutions():
            yield
    finally:
        _active.depth -= 1


def cpu_bf16_convolutions(x: torch.Tensor, bf16: bool | None = None):
    """The guard for a call on ``x``: a context in which bf16 convolutions of
    CPU tensors are fp32 sums rounded once. It enters only where ``x`` lies
    on the CPU and the call computes in bf16 (``bf16``, by default
    ``x.dtype == torch.bfloat16``), and not again inside itself; elsewhere
    it is a null context, so the card's calls and fp32 run as they are."""
    bf16 = x.dtype == torch.bfloat16 if bf16 is None else bf16
    if x.device.type != "cpu" or not bf16 or getattr(_active, "depth", 0):
        return contextlib.nullcontext()
    return _guarded()


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation in the
    backward pass runs under the guard where the forward did, wherever the
    backward is called."""
    guarded = getattr(_active, "depth", 0) > 0
    return contextlib.nullcontext(), _guarded() if guarded else contextlib.nullcontext()
