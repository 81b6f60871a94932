"""The port's guard of bf16 convolutions on the CPU
(``remfx_tpu_torch/utils/device.py:cpu_bf16_convolutions``).

On a CPU with AMX, the oneDNN of torch 2.13.0+cpu computes some bf16
convolutions wrong: ``F.conv1d`` of 16 to 16 channels, kernel 8, stride 4,
at 2 x 16 x 8192 is 0.83 x its output's norm off the fp32 sums of its bf16
operands (the operands below; 1.09 with others), and the small HDemucs
below meets the fault in its time branch (8 to 16 channels at stride 4:
0.73 x). A sound bf16 kernel (cuDNN's, XLA's) sums the bf16 operands'
products in fp32 and rounds once: one bf16 rounding, 2^-8 of the output's
norm. Each check here holds the port's own
entry points to that, with no test-owned mode or flag:

* a bf16 ``F.conv1d`` at that shape under the guard (measured 1.66e-3 of
  the norm; 0.83 unguarded);
* every convolution of a small HDemucs' bf16 ``sample``, each layer's
  output against the fp32 sums of the bf16 input and weights it was given
  (measured at most 1.7e-3; the faulty layer 0.73 unguarded);
* a bf16-mixed ``RemovalTask`` step of the TCN with ``remat``: every
  convolution of the forward pass and of the backward pass's
  recomputation likewise, and the step equal bit for bit to the step
  without ``remat``.

On another CPU the fault does not show, and the checks pass with or without
the guard. fp32 convolutions are left as they are, bit for bit, and so is
every tensor that is not on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from remfx_tpu_torch.models import make_model
from remfx_tpu_torch.train import tasks as ttasks
from remfx_tpu_torch.utils.device import cpu_bf16_convolutions

torch.set_num_threads(2)
BF16 = torch.bfloat16
ONE_ROUNDING = 2.0 ** -8  # of the output's norm
CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)
DEMUCS = dict(sources=["mixture"], audio_channels=1, nfft=4096, channels=4, depth=6)
TCN = dict(nblocks=3, channel_width=16, kernel_size=3, dilation_growth=2)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm())


def _operands(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 8192, generator=g).to(BF16)
    w = (torch.randn(16, 16, 8, generator=g) / 11.0).to(BF16)
    b = torch.randn(16, generator=g).to(BF16)
    return x, w, b


class _LayerCheck:
    """Forward hooks on every convolution layer: each output against the
    fp32 sums of the bf16 input and parameters that the layer was given
    (``torch.func.functional_call`` of the layer on their fp32 copies)."""

    def __init__(self, module: nn.Module):
        self.errors = []
        self._inside = False
        self.handles = [m.register_forward_hook(self._hook) for m in module.modules()
                        if isinstance(m, CONVS)]

    def _hook(self, layer, args, out):
        if self._inside:
            return
        self._inside = True
        try:
            with torch.no_grad():
                params = {k: v.detach().float() for k, v in layer.named_parameters()}
                want = torch.func.functional_call(layer, params, (args[0].detach().float(),))
            assert out.dtype == BF16
            self.errors.append(_rel(out.detach(), want))
        finally:
            self._inside = False

    def remove(self):
        for h in self.handles:
            h.remove()


def test_bf16_conv1d_is_fp32_sums_rounded_once():
    x, w, b = _operands()
    want = F.conv1d(x.float(), w.float(), b.float(), stride=4)
    with cpu_bf16_convolutions(x):
        got = F.conv1d(x, w, b, stride=4)
    assert got.dtype == BF16
    assert _rel(got, want) <= ONE_ROUNDING


def test_bf16_hdemucs_sample_convolutions_are_fp32_sums_rounded_once():
    torch.manual_seed(0)
    wrapper = make_model("demucs", device="cpu", **DEMUCS).to(BF16)
    x = (0.1 * torch.randn(2, 1, 8192, generator=torch.Generator().manual_seed(1))).to(BF16)
    check = _LayerCheck(wrapper)
    try:
        y = wrapper.sample(x)
    finally:
        check.remove()
    assert y.dtype == BF16 and bool(torch.isfinite(y.float()).all())
    assert len(check.errors) == sum(isinstance(m, CONVS) for m in wrapper.modules())
    assert max(check.errors) <= ONE_ROUNDING, max(check.errors)


def _tcn_step(remat: bool):
    torch.manual_seed(0)
    wrapper = make_model("tcn", device="cpu", remat=remat, **TCN)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy((0.1 * rng.standard_normal((2, 1, 8192))).astype(np.float32))
            for _ in range(2))
    task = ttasks.RemovalTask(wrapper, max_steps=100, precision="bf16-mixed")
    check = _LayerCheck(wrapper)
    try:
        _, metrics = task.train_step(task.init_state(), (x, y))
    finally:
        check.remove()
    return wrapper, metrics, check.errors


def test_bf16_mixed_tcn_remat_step_is_fp32_sums_rounded_once():
    wrapper, metrics, errors = _tcn_step(remat=True)
    plain, plain_metrics, plain_errors = _tcn_step(remat=False)
    n_convs = sum(isinstance(m, CONVS) for m in wrapper.modules())
    # the recomputation ran convolutions again (it stops once it has what
    # the backward pass needs)
    assert len(errors) > len(plain_errors) == n_convs
    assert max(errors) <= ONE_ROUNDING, max(errors)
    assert torch.equal(metrics["train_loss"], plain_metrics["train_loss"])
    for (name, p), q in zip(wrapper.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(p, q), name


def test_fp32_convolutions_are_untouched_bit_for_bit():
    x, w, b = _operands(seed=1)
    x, w, b = x.float(), w.float(), b.float()
    want = F.conv1d(x, w, b, stride=4)
    with cpu_bf16_convolutions(x.to(BF16)):  # entered: the call runs in bf16
        got = F.conv1d(x, w, b, stride=4)
    assert torch.equal(got, want)
    torch.manual_seed(0)
    wrapper = make_model("tcn", device="cpu", **TCN)
    xa = torch.randn(2, 1, 4096)
    with torch.no_grad():
        want = wrapper.module(xa)
        assert torch.equal(wrapper.sample(xa), want)
        with cpu_bf16_convolutions(xa.to(BF16)):
            assert torch.equal(wrapper.module(xa), want)


@pytest.mark.parametrize("device,dtype,bf16,entered", [
    ("cpu", BF16, None, True),
    ("cpu", torch.float32, None, False),
    ("cpu", torch.float32, True, True),  # bf16-mixed: an fp32 batch, bf16 compute
    ("meta", BF16, None, False),  # not the CPU: nothing is entered
    ("meta", torch.float32, True, False),
])
def test_the_guard_enters_only_for_bf16_on_the_cpu(device, dtype, bf16, entered):
    x = torch.empty(2, 3, device=device, dtype=dtype)
    ctx = cpu_bf16_convolutions(x, bf16)
    assert (type(ctx).__name__ != "nullcontext") == entered
    with ctx:  # entered once: not again inside itself
        again = cpu_bf16_convolutions(torch.empty(2, 3, dtype=BF16))
        assert (type(again).__name__ == "nullcontext") == entered
