"""HDemucs's GroupNorm and the activation after it (``ops/group_norm.py``,
``models/demucs.py:GroupNormAct``) on the CPU.

The plain path, which CPU tensors take, is torch's composition
``nn.GroupNorm`` -> ``nn.GELU`` / ``nn.GLU`` / GLU -> LayerScale -> + the
residual, bit for bit. The statistics pass's chunking is chosen from the
shape alone. HDemucs keeps torchaudio's state-dict names, and under
autograd its forward and its gradients are those of the modules as they
were composed before the fusion. The backward pass of the kernel's path,
from the forward's statistics, gives torch's gradients. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch
from torch import nn

from remfx_tpu_torch.models import demucs
from remfx_tpu_torch.models.demucs import DConv, GroupNormAct, HDemucs, LayerScale
from remfx_tpu_torch.ops import group_norm as gn
from tests._torch_hdemucs import HDemucs as OracleHDemucs

torch.set_num_threads(2)
CSRC = Path(__file__).resolve().parents[1] / "remfx_tpu_torch" / "csrc" / "group_norm.cu"
SMALL = dict(sources=("mixture",), audio_channels=1, channels=8, nfft=64, depth=3,
             norm_starts=1, dconv_lstm=2, dconv_attn=1)


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (0.5 + 2.0 * torch.randn(shape, generator=g)).to(dtype)


def _old(norm: nn.GroupNorm, act, x, residual=None, layer_scale=None):
    """The modules as HDemucs composed them before the fusion."""
    y = nn.GroupNorm.forward(norm, x)
    if act == "gelu":
        y = nn.GELU()(y)
    elif act == "glu":
        y = nn.GLU(1)(y)
    if residual is not None:
        y = residual + layer_scale(y)
    return y


# rows x groups: 12 and 160, fewer and more than the card's 132 SMs; 37 and
# 1003 samples: no multiple of a pack (8 bf16, 4 fp32); one 4-d shape as the
# frequency branch's encoder norms see (the residual is the DConv's: 3-d)
SHAPE_ACTS = [(shape, act) for shape in [(3, 8, 37), (40, 8, 1003), (5, 16, 3, 37)]
              for act in ["gelu", "glu", "glu+residual"]
              if len(shape) == 3 or act != "glu+residual"]


@pytest.mark.parametrize("shape,act", SHAPE_ACTS)
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_is_the_old_composition_bit_for_bit(shape, act, groups, dtype):
    C = shape[1]
    torch.manual_seed(1)
    old = nn.GroupNorm(groups, C).to(dtype)
    with torch.no_grad():
        old.weight.normal_()
        old.bias.normal_()
    name = act.split("+")[0]
    new = GroupNormAct(groups, C, name).to(dtype)
    new.load_state_dict(old.state_dict())
    x = _x(shape, dtype)
    residual = layer_scale = None
    if act == "glu+residual":
        residual = _x((shape[0], C // 2, *shape[2:]), dtype, seed=1)
        layer_scale = LayerScale(C // 2, 0.3).to(dtype)
    with torch.no_grad():
        want = _old(old, name, x, residual, layer_scale)
        got = new(x, residual, None if layer_scale is None else layer_scale.scale)
    assert got.dtype == dtype and torch.equal(got, want)


def test_kernel_constants_mirror_the_source():
    src = CSRC.read_text()
    for name, value in (("kThreads", gn.THREADS), ("kMinPacks", gn.MIN_PACKS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


# (shape, groups, pack) of the benchmark's HDemucs (channels 48, nfft 4096,
# depth 6) at 24 rows x 262144 samples in bf16 -> chunks a (row, group)
BENCH_SHAPES = [
    ((24, 96, 65536), 1, 8, 44),   # time branch, layer 0: the largest groups
    ((24, 12, 65536), 1, 8, 44),
    ((24, 24, 16384), 1, 8, 44),
    ((24, 48, 4096), 1, 8, 24),    # shorter: no thread under MIN_PACKS packs
    ((24, 96, 1024), 1, 8, 12),
    ((12288, 96, 256), 1, 8, 1),   # frequency branch, layer 0: B x Fr rows
    ((12288, 12, 256), 1, 8, 1),
    ((3072, 192, 256), 1, 8, 1),
    ((768, 48, 256), 1, 8, 1),
    ((24, 768, 1, 256), 4, 8, 6),  # the collapsed frequency layer's GroupNorm(4)
    ((24, 768, 258), 4, 1, 11),    # 258 samples: element by element
    ((24, 384, 1028), 4, 1, 11),
]


@pytest.mark.parametrize("shape,groups,pack,want", BENCH_SHAPES)
def test_chunking_of_the_benchmarks_hdemucs_shapes(shape, groups, pack, want):
    rows = shape[0] * groups
    packs = shape[1] // groups * shape[-1] * (shape[2] if len(shape) == 4 else 1) // pack
    k = gn.chunks(rows, packs)
    assert k == want
    length = -(-packs // k)
    assert (k - 1) * length < packs  # no chunk is empty
    assert k == 1 or length >= gn.THREADS * gn.MIN_PACKS
    if rows >= gn.TARGET_BLOCKS:
        assert k == 1  # the groups alone fill the card: one block each


def test_chunking_leaves_no_chunk_empty():
    for rows in (1, 7, 24, 131, 1056, 5000):
        for packs in (1, 5, 1023, 1024, 4097, 10**5 + 7, 5 * 10**6):
            k = gn.chunks(rows, packs)
            length = -(-packs // k)
            assert 1 <= k and (k - 1) * length < packs <= k * length, (rows, packs)


def test_hdemucs_state_dict_keeps_torchaudios_names():
    torch.manual_seed(0)
    ours = HDemucs(**SMALL).state_dict()
    oracle = OracleHDemucs(**SMALL).state_dict()
    assert list(ours) == list(oracle)
    assert all(ours[k].shape == oracle[k].shape for k in ours)
    assert any(isinstance(m, GroupNormAct) for m in HDemucs(**SMALL).modules())


def _stats_fused(x, groups, weight, bias, eps, act, residual, scale, stats=False):
    """The kernel's launcher as the plain composition: the output, and each
    group's fp32 (mean, rstd) from torch's own GroupNorm."""
    out = gn.group_norm_plain(x, groups, weight, bias, eps, act, residual, scale)
    if not stats:
        return out, None
    N, C = x.shape[:2]
    _, mean, rstd = torch.native_group_norm(x.float(), None, None, N, C,
                                            x[0, 0].numel(), groups, eps)
    return out, torch.stack([mean, rstd], -1)


def test_group_norm_takes_the_kernel_for_every_card_call(monkeypatch):
    """On a tensor off the CPU (meta here, a card's in use), the kernel
    path is taken in no-grad mode, when nothing requires grad and under
    autograd, where it also asks for the statistics and records its own
    backward pass."""
    calls = []

    def fused(*args, stats=False):
        calls.append(stats)
        return _stats_fused(*args, stats=stats)

    monkeypatch.setattr(gn, "_fused", fused)
    norm = GroupNormAct(1, 8, "glu").to("meta")
    x = torch.empty(2, 8, 16, device="meta")
    with torch.no_grad():
        norm(x)
    assert calls == [False]
    with torch.enable_grad():
        y = norm(x)
    assert calls == [False, True] and y.requires_grad
    assert type(y.grad_fn).__name__ == "_GroupNormActBackward"
    norm.requires_grad_(False)
    with torch.enable_grad():
        norm(x)
    assert calls == [False, True, False]
    with torch.enable_grad():
        norm(x.requires_grad_())
    assert calls == [False, True, False, True]


# which of (x, weight, bias, residual, scale) require grad
NEEDS = [(True,) * 5, (False, True, True, True, False), (True, False, False, False, True)]


@pytest.mark.parametrize("shape,act", SHAPE_ACTS)
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_from_the_statistics_gives_torchs_gradients(shape, act, groups, dtype):
    """``group_norm_backward``, given the forward's fp32 statistics, against
    autograd through torch's composition: within fp32's rounding of the
    recomputed norm, and bf16's."""
    C = shape[1]
    g = torch.Generator().manual_seed(2)
    x = _x(shape, dtype).requires_grad_()
    w = (1.0 + 0.5 * torch.randn(C, generator=g)).to(dtype).requires_grad_()
    b = (0.1 * torch.randn(C, generator=g)).to(dtype).requires_grad_()
    name, residual, scale = act.split("+")[0], None, None
    if act == "glu+residual":
        residual = _x((shape[0], C // 2, *shape[2:]), dtype, seed=1).requires_grad_()
        scale = (0.3 * torch.randn(C // 2, generator=g)).to(dtype).requires_grad_()
    out = gn.group_norm_plain(x, groups, w, b, 1e-5, name, residual, scale)
    grad = torch.randn(out.shape, generator=g).to(dtype)
    inputs = [t for t in (x, w, b, residual, scale) if t is not None]
    want = torch.autograd.grad(out, inputs, grad)
    stats = _stats_fused(x.detach(), groups, w, b, 1e-5, name, None, None, stats=True)[1]
    with torch.no_grad():
        got = gn.group_norm_backward(grad, x.detach(), groups, w.detach(), b.detach(),
                                     stats[..., 0], stats[..., 1], name,
                                     None if scale is None else scale.detach(),
                                     (True, True, True, residual is not None,
                                      scale is not None))
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for a, e in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6 * e.abs().max().item())
        else:
            torch.testing.assert_close(a, e)


@pytest.mark.parametrize("needs", NEEDS)
@pytest.mark.parametrize("act", ["gelu", "glu", "glu+residual"])
def test_autograd_function_hands_back_torchs_gradients(monkeypatch, act, needs):
    """The kernel path's ``autograd.Function``, its launcher replaced by the
    plain composition on the CPU: the gradients of what requires grad, and
    None of the rest, as autograd through torch's composition gives them."""
    monkeypatch.setattr(gn, "_fused", _stats_fused)
    g = torch.Generator().manual_seed(4)
    name = act.split("+")[0]
    tensors = [_x((3, 8, 45), torch.float32), 1.0 + torch.randn(8, generator=g),
               0.1 * torch.randn(8, generator=g), None, None]
    if act == "glu+residual":
        tensors[3:] = [_x((3, 4, 45), torch.float32, seed=5), torch.randn(4, generator=g)]
    leaves = [None if t is None else t.clone().requires_grad_(n)
              for t, n in zip(tensors, needs)]
    with torch.enable_grad():
        out = gn._GroupNormAct.apply(*leaves, 4, 1e-5, name)
        want_out = gn.group_norm_plain(leaves[0], 4, *leaves[1:3], 1e-5, name, *leaves[3:])
    grad = torch.randn(out.shape, generator=g)
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    got = torch.autograd.grad(out, wanted, grad)
    want = torch.autograd.grad(want_out, wanted, grad)
    assert torch.equal(out.detach(), want_out.detach())
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6 * e.abs().max().item())


def test_last_decoder_normed_without_activation_is_torchs_groupnorm():
    """With ``norm_starts=0`` the last decoder has a norm and no
    activation: a plain ``nn.GroupNorm``, under torchaudio's names."""
    cfg = dict(SMALL, sources=("drums", "bass"), audio_channels=2, norm_starts=0)
    torch.manual_seed(0)
    model, oracle = HDemucs(**cfg), OracleHDemucs(**cfg)
    assert list(model.state_dict()) == list(oracle.state_dict())
    assert type(model.freq_decoder[-1].norm2) is nn.GroupNorm
    assert type(model.time_decoder[-1].norm2) is nn.GroupNorm
    oracle.load_state_dict(model.state_dict())
    x = 0.1 * _x((2, 2, 800), torch.float32)
    with torch.no_grad():
        want = oracle(x)  # (B, sources, channels, T): ours folds the sources
        torch.testing.assert_close(model(x).view(want.shape), want, rtol=1e-5, atol=1e-6)


def test_group_norm_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 16)
    w = torch.ones(8)
    with pytest.raises(ValueError, match="act must be"):
        gn.group_norm(x, 1, w, w, act="relu")
    with pytest.raises(ValueError, match="together"):
        gn.group_norm(x, 1, w, w, act="gelu", residual=x[:, :4], scale=w[:4])
    with pytest.raises(ValueError, match="no group_norm kernel for device meta"):
        gn._fused(x.to("meta"), 1, w, w, 1e-5, "gelu", None, None)


def _parent_forward(monkeypatch):
    """The modules composed as before the fusion: each norm then its
    activation as separate modules, ``x + layer(x)`` in the DConv. (The
    decoders' GELU now comes before their crop, as in the fused forward:
    it is elementwise, so the kept values are the same.)"""
    def norm_then_act(self, x, residual=None, scale=None):
        return _old(self, self.act, x)

    def dconv(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x

    monkeypatch.setattr(GroupNormAct, "forward", norm_then_act)
    monkeypatch.setattr(DConv, "forward", dconv)


def _forward_and_grads(model, x):
    model.zero_grad()
    y = model(x)
    (y * torch.linspace(-1.0, 1.0, y.shape[-1])).square().sum().backward()
    return [y.detach()] + [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hdemucs_under_autograd_is_the_parents_forward_and_gradients(monkeypatch, dtype):
    torch.manual_seed(3)
    model = HDemucs(**SMALL).to(dtype)
    x = _x((2, 1, 800), dtype) * 0.1
    with torch.enable_grad():
        fused = _forward_and_grads(model, x)
        with monkeypatch.context() as m:
            _parent_forward(m)
            parent = _forward_and_grads(model, x)
    assert len(fused) == len(parent) == 1 + len(list(model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(fused, parent))


def test_dconv_takes_the_residual_in_its_second_norm(monkeypatch):
    seen = []
    real = gn.group_norm

    def spy(x, groups, weight, bias, eps=1e-5, act="gelu", residual=None, scale=None):
        seen.append((act, residual is not None))
        return real(x, groups, weight, bias, eps, act, residual, scale)

    monkeypatch.setattr(demucs, "group_norm", spy)
    dconv = DConv(16)
    with torch.no_grad():
        dconv(torch.randn(2, 16, 50))
    assert seen == [("gelu", False), ("glu", True)] * 2
    assert [type(m) for m in dconv.layers[0]] == [
        nn.Conv1d, GroupNormAct, nn.Identity, nn.Conv1d, GroupNormAct, nn.Identity, LayerScale]
