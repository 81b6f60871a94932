"""The removal model's training step, closed loop over pre-made batches.

Each step copies a batch of (wet, dry) crops from pinned host memory to
the device (range ``h2d``), calls ``RemovalTask.train_step(state, (x, y))``
(range ``step``; autograd's and AdamW's own ranges inside it), and ends
when its loss has been read on the host, as the training loop's logger
reads it.

``correct``: set-up builds one task and state from the seeded weights and
drives it through its first ``warmup_steps`` steps, which warm up every
shape; the window goes on with that same state, and its first steps make
up the ``checked_steps`` with them. Every step takes the pool's batches in
turn, whose rows all differ. Kept: each checked step's loss, each leaf's
norm of the first gradient as AdamW got it (its first moment after one
step over 1 - beta1), and the parameters as the last checked step leaves
them (copied to the host inside the window), whose change from the seeded
weights is taken leaf by leaf. Once the window has closed and the program
is freed, the reference takes the same steps from the same weights and
batches, and the worst gaps are held to the workload's limits.
"""

from __future__ import annotations

import statistics

import torch
from torch.profiler import record_function

from perfbench import flops
from perfbench.drivers import factory_keys, sync
from perfbench.reference import fp32_exact
from perfbench.reference import models as ref_models
from perfbench.reference.train import AdamW, train_steps
from perfbench.traffic import crops
from perfbench.weights import derive, seed_module_

WEIGHTS = 200
# leaves whose reference gradient is under this share of the median
# leaf's move under AdamW by rounding alone; their change is not compared.
# At the cell's sizes only the attention's key biases, which softmax makes
# gradient-free, fall under it: their fp32 gradient is 1e-11 to 2e-10 of
# the median leaf's and 3e8 to 2e9 times an fp64 one; the next smallest,
# from 4e-7 of the median, lie within 6 % of fp64
NOUGHT = 1e-8


class Cell:
    def __init__(self, config: dict, spec: dict, seed: int, device):
        self.cfg, self.spec, self.seed = config, spec, int(seed)
        self.device = torch.device(device)
        self.rows, self.samples = spec["rows"], spec["samples"]
        self.warmup, self.checked = spec["warmup_steps"], spec["checked_steps"]

    def _reference_model(self):
        with torch.device(self.device):
            module = ref_models.build(self.cfg["model"])
        seed_module_(module, derive(self.seed, WEIGHTS), self.cfg["model"]["init"])
        return module

    def setup(self):
        from remfx_tpu_torch.models import make_model
        from remfx_tpu_torch.train.tasks import RemovalTask

        cfg, spec, dev = self.cfg, self.spec, self.device
        gen = torch.Generator().manual_seed(derive(self.seed, 0))
        x, y = crops(spec["pairs"], spec["pool_batches"], self.rows, self.samples,
                     spec["gain_db"], gen, dev)
        pin = dev.type == "cuda"
        self.pool = (x.cpu().pin_memory() if pin else x.cpu(), y.cpu().pin_memory() if pin else y.cpu())
        del x, y

        kw = factory_keys(cfg["model"])
        with torch.device(dev):
            wrapper = make_model(cfg["model"]["kind"], device=dev, **kw)
        wrapper.module.load_state_dict(self._reference_model().state_dict(), strict=True)
        opt = cfg["optimizer"]
        self.task = RemovalTask(wrapper, lr=opt["lr"], lr_beta1=opt["betas"][0],
                                lr_beta2=opt["betas"][1], lr_eps=opt["eps"],
                                lr_weight_decay=opt["weight_decay"], max_steps=opt["max_steps"],
                                gradient_clip_val=cfg["gradient_clip_val"],
                                sample_rate=cfg["sample_rate"], precision=cfg["precision"])
        self.state = self.task.init_state()
        names = [n for n, _ in wrapper.module.named_parameters()]
        params = [p for _, p in wrapper.module.named_parameters()]
        self.after = torch.empty(sum(p.numel() for p in params), pin_memory=dev.type == "cuda")
        self.first, self.losses = 0, []
        for i in range(self.warmup):
            self.iteration(i)
            if i == 0:  # a leaf that AdamW holds no moment for was never updated: 0
                state, beta1 = self.state.optimizer.state, opt["betas"][0]
                self.grad = {n: (state[p]["exp_avg"].norm() / (1 - beta1)).item()
                             if "exp_avg" in state.get(p, {}) else 0.0
                             for n, p in zip(names, params)}
        self.first = self.warmup
        sync(dev)

    def choose_samples(self, first):
        """The checked steps are set-up's and the window's first ones."""

    def iteration(self, i: int) -> float:
        k = (self.first + i) % self.pool[0].shape[0]
        with record_function("h2d"):
            x = self.pool[0][k].to(self.device, non_blocking=True)
            y = self.pool[1][k].to(self.device, non_blocking=True)
        with record_function("step"):
            _, metrics = self.task.train_step(self.state, (x, y))
        loss = metrics["train_loss"].item()
        step = self.first + i + 1
        if step <= self.checked:
            self.losses.append(loss)
        if step == self.checked:
            self.offsets, o = {}, 0
            with torch.no_grad():
                for n, p in self.task.wrapper.module.named_parameters():
                    self.after[o:o + p.numel()].copy_(p.flatten(), non_blocking=True)
                    self.offsets[n], o = o, o + p.numel()
        return self.rows * self.samples / self.cfg["sample_rate"]

    def release(self):
        del self.task, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correct ----

    def reference(self):
        """-> (losses, {leaf: first gradient norm}, {leaf: change norm}) of
        the reference's checked steps."""
        cfg, opt = self.cfg, self.cfg["optimizer"]
        model = self._reference_model().train()
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        p0 = [p.detach().clone() for p in params]
        batches = [(self.pool[0][k].to(self.device), self.pool[1][k].to(self.device))
                   for k in range(self.checked)]
        losses, first = train_steps(model, batches,
                                    AdamW(params, opt["lr"], opt["betas"], opt["eps"],
                                          opt["weight_decay"]),
                                    cfg["gradient_clip_val"], self.spec["reference_block_rows"])
        with torch.no_grad():
            change = {n: (p - q).norm().item() for n, p, q in zip(names, params, p0)}
        return losses, dict(zip(names, first)), change

    def got(self):
        """-> (losses, {leaf: first gradient norm}, {leaf: change norm}) of
        the program's checked steps; None where the window ended before
        them."""
        if len(self.losses) < self.checked:
            return None
        sync(self.device)  # the copies of the parameters to the host
        change = {}
        with torch.no_grad():
            for n, p in self._reference_model().named_parameters():
                o = self.offsets[n]
                after = self.after[o:o + p.numel()].to(self.device).view_as(p)
                change[n] = (after - p).norm().item()
        return self.losses, self.grad, change

    @staticmethod
    def compare(got, want, nought: float = NOUGHT) -> dict:
        """got, want: (losses, grad norms, change norms) -> the numbers compared."""
        (loss, grad, change), (loss_r, grad_r, change_r) = got, want
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss, loss_r))
        med = statistics.median(grad_r.values())
        grad_gap = max(abs(grad[n] - g) / max(g, med) for n, g in grad_r.items())
        moved = [n for n, g in grad_r.items() if g >= nought * med]
        med_c = statistics.median(change_r[n] for n in moved)
        change_gap = max(abs(change[n] - change_r[n]) / max(change_r[n], med_c) for n in moved)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

    def verify(self):
        limits = self.spec["limits"]
        got = self.got()
        if got is None:
            return [(name, float("inf"), limit) for name, limit in limits.items()]
        with fp32_exact():
            numbers = self.compare(got, self.reference())
        return [(name, numbers[name], limit) for name, limit in limits.items()]

    def flops_per_iteration(self) -> int:
        return flops.train_step_flops(self.cfg["model"], self.rows, self.samples)
