"""DPTNet's removal training step: ``train_step``'s window and comparison,
with the reference model of ``perfbench/reference/dptnet.py``, whose
checked steps run in fp64 (``Cell.reference``), and a fourth check,
``out_gap``, on the first step's output (``Cell.compare``).

Seeded weights: ``perfbench/weights.py`` draws the convolutions, linear
layers (the attention's ``out_proj`` among them) and LSTMs from the seed
under ``init``, and keeps the norms' and PReLU's constants. Two leaves are
neither affine layers nor constant, so they are drawn here from a stream
of their own under the same seed, as the program's constructors draw
them: the attention's ``in_proj_weight`` xavier-uniform (torch's
``nn.MultiheadAttention``), and both filterbanks' ``_filters`` N(0, 1) /
sqrt(kernel) (``remfx_tpu_torch/models/dptnet.py``). The attention's
``in_proj_bias`` keeps torch's 0.
"""

from __future__ import annotations

import math

import torch

from perfbench import flops
from perfbench.drivers import train_step
from perfbench.reference.dptnet import DPTNet
from perfbench.reference.train import AdamW, removal_loss, train_steps
from perfbench.weights import derive, seed_module_

# the stream of the leaves that ``perfbench/weights.py`` does not draw
OWN_LEAVES = 201


def build(entry: dict) -> DPTNet:
    """A configuration's model entry -> the reference DPTNet, in fp32 on the
    current default device."""
    return DPTNet(**{k: v for k, v in entry.items() if k not in ("kind", "init")})


def _own_leaves(module):
    """[(parameter, 'xavier' | 'filters')] in the module's order."""
    return [(p, "xavier" if name.endswith("in_proj_weight") else "filters")
            for name, p in module.named_parameters()
            if name.endswith(("in_proj_weight", "_filters"))]


@torch.no_grad()
def seed_dptnet_(module, seed: int, init: str) -> dict:
    """Fill every leaf of the reference DPTNet from ``seed`` -> its state dict."""
    own = _own_leaves(module)
    for p, _ in own:
        p.zero_()
    seed_module_(module, derive(seed, train_step.WEIGHTS), init)
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(derive(seed, OWN_LEAVES))
    for p, kind in own:
        if kind == "xavier":
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_(torch.rand(p.shape, generator=gen, device=device).mul_(2).sub_(1) * bound)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device) / math.sqrt(p.shape[-1]))
    return module.state_dict()


class Cell(train_step.Cell):
    def _reference_model(self):
        with torch.device(self.device):
            module = build(self.cfg["model"])
        seed_dptnet_(module, self.seed, self.cfg["model"]["init"])
        return module

    def iteration(self, i: int) -> float:
        if self.first or i:
            return super().iteration(i)
        # set-up's first step: keep the output the loss takes, on the host
        kept = []
        handle = self.task.wrapper.register_forward_hook(
            lambda module, args, out: kept.append(out.detach().to("cpu", torch.float64)))
        try:
            work = super().iteration(i)
        finally:
            handle.remove()
        self.output = torch.cat(kept)
        return work

    def got(self):
        """-> train_step's three readings and the first step's output."""
        got = super().got()
        return None if got is None else (*got, self.output)

    def reference(self, dtype=torch.float64):
        """-> (losses, {leaf: first gradient norm}, {leaf: change norm}, the
        first step's output) of the reference's checked steps, in fp64 from
        the same fp32 weights and batches. DPTNet's fp32 gradient is
        ill-conditioned: where one STFT bin of the output crosses the loss's
        magnitude floor by rounding, every leaf's gradient moves by some
        4e-4, and a leaf that sums tens of millions of terms of both signs
        (the PReLU's scalar, the gLN gains) moves by up to 1e-3 with the
        order of its sums; TF32 moves them no further. The output, which has
        no such sums, tells TF32 from fp32."""
        opt, rows = self.cfg["optimizer"], self.spec["reference_block_rows"]
        model = self._reference_model().to(dtype).train()
        names, params = zip(*model.named_parameters())
        p0 = [p.detach().clone() for p in params]
        batches = [(self.pool[0][k].to(self.device, dtype), self.pool[1][k].to(self.device, dtype))
                   for k in range(self.checked)]
        with torch.no_grad():
            x = batches[0][0]
            output = torch.cat([model(x[i:i + rows]).to("cpu", torch.float64)
                                for i in range(0, x.shape[0], rows)])
        losses, first = train_steps(model, batches,
                                    AdamW(params, opt["lr"], opt["betas"], opt["eps"],
                                          opt["weight_decay"]),
                                    self.cfg["gradient_clip_val"], rows)
        with torch.no_grad():
            change = {n: (p - q).norm().item() for n, p, q in zip(names, params, p0)}
        return losses, dict(zip(names, first)), change, output

    @staticmethod
    def compare(got, want, nought: float = train_step.NOUGHT) -> dict:
        """train_step's gaps, and ``out_gap``: the first step's output
        against the reference's, the worst row's norm of the difference over
        the reference row's norm (inf where the rows differ in number)."""
        numbers = train_step.Cell.compare(got[:3], want[:3], nought)
        out, out_r = got[3], want[3]
        if out.shape != out_r.shape:
            numbers["out_gap"] = math.inf
        else:
            d, r = (out - out_r).flatten(1), out_r.flatten(1)
            numbers["out_gap"] = (d.norm(dim=1) / r.norm(dim=1)).max().item()
        return numbers

    def flops_per_iteration(self) -> int:
        """Forward, removal loss and backward of the reference over (rows, 1,
        samples): convolutions, the attention's projections and products,
        the LSTMs' gates (``perfbench/flops.py``)."""
        with torch.device("meta"):
            model = build(self.cfg["model"]).train()
        x = torch.empty(self.rows, 1, self.samples, device="meta")
        y = torch.empty(self.rows, 1, self.samples, device="meta")
        return flops._count(model, lambda: removal_loss(model(x), y).backward(), passes=3)
