"""The detect -> remove chain over batches of files, closed loop, one client.

Each batch: ``ChainInference.detect(x)`` on the classifier's chain, then
``ChainInference.run(x, pinned + 0.0 * detected)`` on the classifier-less
chain in the configured dispatch, so that the chain's one readback of the
label counts waits for the classifier while the labels keep their pinned
values; the batch ends when its output is on the host. Ranges: ``detect``,
``remove``, ``d2h``.

``correct``: a few batches drawn from the seed keep their output and
Cnn14's logits (forward hooks on the classifier's heads, whose sigmoids
are the probabilities); once the window has closed and the program is
freed, the reference recomputes both in fp32 from the same seeded weights
and inputs. Held to the workload's limits: ``out_err``, the worst row's
relative L2 error of the chain's output, and ``logit_err``, the largest
gap of a logit over the RMS of the batch's reference logits. Logits and
not probabilities: with seeded weights the probabilities sit near 0.5,
where a bf16 probability's own rounding (2^-9) is larger than what an
fp8 trunk changes.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench import flops
from perfbench.drivers import factory_keys, sync
from perfbench.reference import chain as ref_chain
from perfbench.reference import fp32_exact
from perfbench.reference import models as ref_models
from perfbench.traffic import crops, pinned_labels
from perfbench.weights import derive, seed_module_


class Cell:
    def __init__(self, config: dict, spec: dict, seed: int, device):
        self.cfg, self.spec, self.seed = config, spec, int(seed)
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.rows, self.samples = spec["rows"], spec["samples"]
        self.kept, self.sampled = {}, set()

    # ---- weights: the benchmark's, drawn from the seed ----

    def _reference(self, entry: dict, stream: int):
        """The reference module with the seeded weights rounded to the
        served dtype, in fp32 on the device."""
        with torch.device(self.device):
            module = ref_models.build(entry)
        with torch.no_grad():
            for t in seed_module_(module, derive(self.seed, stream), entry["init"]).values():
                if t.is_floating_point():
                    t.copy_(t.to(self.dtype))
        return module.eval()

    def _served(self, program, entry: dict, stream: int):
        sd = self._reference(entry, stream).state_dict()
        program.load_state_dict({k: v.to(self.dtype) if v.is_floating_point() else v
                                 for k, v in sd.items()}, strict=True)

    def setup(self):
        from remfx_tpu_torch.chain.inference import ChainInference
        from remfx_tpu_torch.models import make_cnn14, make_model

        cfg, spec, dev = self.cfg, self.spec, self.device
        gen = torch.Generator().manual_seed(derive(self.seed, 0))
        (wet,) = crops([[p] for p in spec["audio"]], spec["pool_batches"], self.rows,
                       self.samples, spec["gain_db"], gen, dev)
        self.pool = wet.to(self.dtype)
        self.labels = pinned_labels(spec["label_counts"], cfg["label_columns"],
                                    spec["label_batches"], self.rows, gen).to(dev)
        self.sample_gen = torch.Generator().manual_seed(derive(self.seed, 1))

        cls_kw = factory_keys(cfg["classifier"])
        with torch.device(dev):
            cls = make_cnn14(device=dev, **cls_kw).to(self.dtype)
        self._served(cls, cfg["classifier"], 100)
        models = {}
        for k, stage in enumerate(cfg["stages"]):
            kw = factory_keys(stage["model"])
            with torch.device(dev):
                wrapper = make_model(stage["model"]["kind"], device=dev, **kw).to(self.dtype)
            self._served(wrapper.module, stage["model"], 101 + k)
            models[stage["name"]] = wrapper
        self._heads = {}
        self._hooks = [head.register_forward_hook(self._keep_head(k))
                       for k, head in enumerate(cls.heads)]
        self.detector = ChainInference({}, cfg["sample_rate"], classifier=cls,
                                       threshold=cfg["threshold"])
        self.remover = ChainInference(models, cfg["sample_rate"],
                                      effect_order=[s["name"] for s in cfg["stages"]],
                                      dispatch=cfg["dispatch"])
        self.host_out = torch.empty(self.pool.shape[1:], dtype=self.dtype,
                                    pin_memory=dev.type == "cuda")
        for i in range(spec["warmup_batches"]):
            self.iteration(-1 - i)
        sync(dev)

    def _keep_head(self, k):
        def keep(module, inputs, output):
            self._heads[k] = output
        return keep

    def choose_samples(self, first):
        """Keep ``sampled_batches`` of the window's first ``first`` batches
        (None: the workload's ``sample_from_first``)."""
        first = self.spec["sample_from_first"] if first is None else first
        n = min(self.spec["sampled_batches"], first)
        self.sampled = set(torch.randperm(first, generator=self.sample_gen)[:n].tolist())

    def iteration(self, i: int) -> float:
        x = self.pool[i % self.pool.shape[0]]
        labels = self.labels[i % self.labels.shape[0]]
        with record_function("detect"):
            detected = self.detector.detect(x)
        with record_function("remove"):
            y, _ = self.remover.run(x, labels + 0.0 * detected)
        with record_function("d2h"):
            self.host_out.copy_(y)
        if i in self.sampled:
            self.kept[i] = (y, torch.cat([self._heads[k] for k in sorted(self._heads)], dim=-1))
        return self.rows * self.samples / self.cfg["sample_rate"]

    def release(self):
        for hook in self._hooks:
            hook.remove()
        del self.detector, self.remover, self.host_out
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correct ----

    def reference(self, batches, control=None):
        """fp32 reference outputs [(logits, y)] of the given batch indices;
        ``control`` turns each reference model into the control's."""
        cfg, block = self.cfg, self.spec["reference_block_rows"]
        control = control or (lambda m: m)
        cls = control(self._reference(cfg["classifier"], 100))
        stages = [(control(self._reference(s["model"], 101 + k)),
                   cfg["label_columns"].index(s["label"]))
                  for k, s in enumerate(cfg["stages"])]
        out = []
        for i in batches:
            x = self.pool[i % self.pool.shape[0]].float()
            labels = self.labels[i % self.labels.shape[0]]
            out.append((ref_chain.in_blocks(cls.logits, x, block),
                        ref_chain.remove(stages, x, labels, block)))
        return out

    @staticmethod
    def compare(got, want) -> dict:
        """got, want: [(logits, y)] -> the numbers compared."""
        logit_err, out_err = 0.0, 0.0
        for (lg, y), (lg_ref, y_ref) in zip(got, want):
            lg, lg_ref = lg.double(), lg_ref.double()
            rms = lg_ref.pow(2).mean().sqrt()
            logit_err = max(logit_err, ((lg - lg_ref).abs().max() / rms).item())
            d = (y.double() - y_ref.double()).flatten(1).norm(dim=1)
            out_err = max(out_err, (d / y_ref.double().flatten(1).norm(dim=1)).max().item())
        return {"logit_err": logit_err, "out_err": out_err}

    def verify(self):
        limits = self.spec["limits"]
        if not self.kept:
            return [(name, float("inf"), limit) for name, limit in limits.items()]
        with fp32_exact():
            numbers = self.compare(self.got(), self.reference(sorted(self.kept)))
        return [(name, numbers[name], limit) for name, limit in limits.items()]

    def got(self):
        """The kept batches' [(logits, y)], in the order of their indices."""
        return [(self.kept[i][1], self.kept[i][0]) for i in sorted(self.kept)]

    # ---- work ----

    def flops_per_iteration(self) -> int:
        """Cnn14 on every row, each removal model on the rows its label
        selects (regroup's padding rows are not useful work)."""
        total = flops.forward_flops(self.cfg["classifier"], 1, self.samples) * self.rows
        per_model = {}
        for stage in self.cfg["stages"]:
            key = repr(sorted(stage["model"].items()))
            if key not in per_model:
                per_model[key] = flops.forward_flops(stage["model"], 1, self.samples)
            total += per_model[key] * self.spec["label_counts"][stage["label"]]
        return total
