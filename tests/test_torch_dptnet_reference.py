"""The port's DPTNet (``remfx_tpu_torch/models/dptnet.py``) against the
benchmark's plain reference (``perfbench/reference/dptnet.py``, written
from asteroid's equations and importing nothing of the port), on the CPU
at a small size with the benchmark's seeded weights
(``perfbench/drivers/train_step_dptnet.py``): the published widths (64
channels in 4 heads of 16, BiLSTMs of 256 a direction) with chunks of
10, one repeat, and 2 rows of 2048 samples.

Both sides run in fp64, so that what separates them is the order of
their sums and nothing of the loss's conditioning: in fp32 the removal
loss's log-magnitudes leave the BiLSTMs' reverse leaves about 1e-3 from
fp64 on either side, while the two fp64 sides agree to about 1e-13.

* forward: within 1e-10 of the reference output's peak (measured
  7e-16);
* every leaf's gradient of the reference's removal loss: within 1e-8 of
  the leaf's norm (measured 6e-14);
* two AdamW steps of ``RemovalTask.train_step`` against the reference's
  ``train_steps`` (clip 10, torch's AdamW written out): every leaf's
  change within 1e-4 of the median leaf's change. The port's removal loss
  sums in fp32 whatever its input's dtype (its gradient lies 8e-9 from
  the reference loss's), and AdamW's division by the root of the second
  moment carries that to about 8e-6 of the median change in the elements
  of smallest gradient;
* two faults planted in the port fail every check: the inter-chunk hop
  one frame too long, and the attention's scores scaled by 1/16 where the
  head size 16 asks 1/4 (measured: output gaps 0.20 and 0.037, gradient
  gaps 0.96 and 0.60, change gaps 14 and 8.8).
"""

import pytest
import torch

from perfbench.drivers.train_step_dptnet import build, seed_dptnet_
from perfbench.reference.train import AdamW, removal_loss, train_steps
from remfx_tpu_torch.models import dptnet as tdpt
from remfx_tpu_torch.models import make_model
from remfx_tpu_torch.train.tasks import RemovalTask

torch.set_num_threads(2)
ENTRY = {"kind": "dptnet", "init": "torch", "n_src": 1, "in_chan": 64, "out_chan": 64,
         "chunk_size": 10, "n_repeats": 1, "fb_name": "free", "kernel_size": 16,
         "n_filters": 64, "stride": 8, "num_bins": 1025}
SEED = 2081723155
ROWS, T = 2, 2048
OUT_TOL, GRAD_TOL, CHANGE_TOL = 1e-10, 1e-8, 1e-4
OPT = dict(lr=1e-4, betas=(0.95, 0.999), eps=1e-6, weight_decay=1e-3)


def _pair():
    reference = build(ENTRY)
    state = seed_dptnet_(reference, SEED, ENTRY["init"])
    kw = {k: v for k, v in ENTRY.items() if k not in ("kind", "init")}
    wrapper = make_model("dptnet", device="cpu", **kw)
    wrapper.module.load_state_dict(state, strict=True)
    reference.load_state_dict(wrapper.module.state_dict(), strict=True)
    return wrapper.double(), reference.double()


def _batches(n):
    gen = torch.Generator().manual_seed(7)
    out = []
    for _ in range(n):
        x = 0.3 * torch.randn(ROWS, 1, T, generator=gen, dtype=torch.float64)
        out.append((x, x + 0.1 * torch.randn(ROWS, 1, T, generator=gen, dtype=torch.float64)))
    return out


def _gaps(wrapper, reference):
    """-> (output gap over the reference's peak, worst leaf's gradient gap
    over the leaf's norm)."""
    x, y = _batches(1)[0]
    out = {}
    for side, module in (("port", wrapper.module), ("ref", reference)):
        names, params = zip(*module.named_parameters())
        o = module(x)
        out[side] = o.detach(), dict(zip(names, torch.autograd.grad(removal_loss(o, y), params)))
    (o, g), (o_r, g_r) = out["port"], out["ref"]
    assert set(g) == set(g_r)
    out_gap = ((o - o_r).abs().max() / o_r.abs().max()).item()
    grad_gap = max(((g[n] - g_r[n]).norm() / g_r[n].norm()).item() for n in g_r)
    return out_gap, grad_gap


def _change_gap(wrapper, reference):
    batches = _batches(2)
    p0 = {n: p.detach().clone() for n, p in reference.named_parameters()}
    task = RemovalTask(wrapper, lr=OPT["lr"], lr_beta1=OPT["betas"][0], lr_beta2=OPT["betas"][1],
                       lr_eps=OPT["eps"], lr_weight_decay=OPT["weight_decay"],
                       gradient_clip_val=10.0)
    state = task.init_state()
    for batch in batches:
        task.train_step(state, batch)
    params = [p for _, p in reference.named_parameters()]
    train_steps(reference.train(), batches, AdamW(params, **OPT), 10.0, ROWS)
    want = {n: p.detach() - p0[n] for n, p in reference.named_parameters()}
    got = {n: p.detach() - p0[n] for n, p in wrapper.module.named_parameters()}
    median = torch.stack([w.norm() for w in want.values()]).median()
    return max(((got[n] - want[n]).norm() / median).item() for n in want)


def _hop_one_too_long(mp):
    unfold, fold = tdpt._unfold, tdpt._fold
    mp.setattr(tdpt, "_unfold", lambda x, chunk, hop: unfold(x, chunk, hop + 1))
    mp.setattr(tdpt, "_fold", lambda seg, frames, hop: fold(seg, frames, hop + 1))


def _scores_over_16(mp):
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def scaled(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, **_):
        return sdpa(q, k, v, attn_mask, dropout_p, is_causal, scale=1.0 / 16)
    mp.setattr(torch.nn.functional, "scaled_dot_product_attention", scaled)


def test_forward_and_every_gradient_match_the_reference():
    out_gap, grad_gap = _gaps(*_pair())
    assert out_gap <= OUT_TOL
    assert grad_gap <= GRAD_TOL


def test_two_adamw_steps_match_the_reference():
    assert _change_gap(*_pair()) <= CHANGE_TOL


@pytest.mark.parametrize("fault", [_hop_one_too_long, _scores_over_16])
def test_planted_fault_fails_the_comparison(monkeypatch, fault):
    wrapper, reference = _pair()
    fault(monkeypatch)
    out_gap, grad_gap = _gaps(wrapper, reference)
    assert out_gap > OUT_TOL and grad_gap > GRAD_TOL
    assert _change_gap(wrapper, reference) > CHANGE_TOL
