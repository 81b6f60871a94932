"""Model factories of the port (``remfx_tpu/models/__init__.py``).

Each factory builds its model on ``device`` (the card unless the caller
names another) in eval mode, with PyTorch's default initialisation;
weights from the JAX package come in through ``compat.from_jax``.
``make_model`` picks a removal factory by name, as the JAX registry does.
"""

from __future__ import annotations

import inspect
import logging

from remfx_tpu_torch.models.cnn14 import Cnn14
from remfx_tpu_torch.models.dcunet import DCUNet
from remfx_tpu_torch.models.demucs import HDemucs
from remfx_tpu_torch.models.dptnet import DPTNet
from remfx_tpu_torch.models.tcn import TCN
from remfx_tpu_torch.models.umx import UMXSeparator
from remfx_tpu_torch.models.wrappers import ModelWrapper
from remfx_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def make_tcn(
    sample_rate=48000,
    num_bins=1025,
    ninputs=1,
    noutputs=1,
    nblocks=20,
    channel_growth=0,
    channel_width=256,
    kernel_size=7,
    stack_size=10,
    dilation_growth=2,
    causal=False,
    remat=True,
    device=None,
    **_ignored,
) -> ModelWrapper:
    """``remat`` checkpoints each block in train mode
    (``torch.utils.checkpoint``), the JAX package's ``nn.remat``
    (``remfx_tpu/models/tcn.py:73-81``): the backward pass recomputes a
    block's activations from its input instead of keeping them."""
    module = TCN(
        ninputs=ninputs,
        noutputs=noutputs,
        nblocks=nblocks,
        channel_growth=channel_growth,
        channel_width=channel_width,
        kernel_size=kernel_size,
        stack_size=stack_size,
        dilation_growth=dilation_growth,
        causal=causal,
        remat=remat,
    )
    return ModelWrapper(module, name="tcn").to(resolve_device(device)).eval()


def make_cnn14(
    num_classes=5,
    sample_rate=48000,
    model_sample_rate=48000,
    n_fft=2048,
    hop_length=512,
    n_mels=128,
    specaugment=False,
    freq_mask_param=64,
    time_mask_param=128,
    device=None,
    **ignored,
) -> Cnn14:
    if ignored:
        log.warning("make_cnn14 ignores network config keys: %s", sorted(ignored))
    net = Cnn14(
        num_classes=num_classes,
        sample_rate=sample_rate,
        model_sample_rate=model_sample_rate,
        n_fft=n_fft,
        hop_length=hop_length,
        n_mels=n_mels,
        specaugment=specaugment,
        freq_mask_param=freq_mask_param,
        time_mask_param=time_mask_param,
    )
    return net.to(resolve_device(device)).eval()


def make_umx(
    sample_rate=48000,
    n_fft=2048,
    hop_length=512,
    n_channels=1,
    alpha=0.3,
    hidden_size=512,
    niter=0,
    softmask=False,
    residual=False,
    wiener_win_len=300,
    identity_init=False,
    device=None,
    **_ignored,
) -> ModelWrapper:
    """``alpha`` is a key of the reference's config that its model never
    reads; it is accepted and unused, as in the JAX package."""
    module = UMXSeparator(
        n_fft=n_fft,
        hop_length=hop_length,
        nb_channels=n_channels,
        hidden_size=hidden_size,
        niter=niter,
        softmask=softmask,
        residual=residual,
        wiener_win_len=wiener_win_len,
        identity_init=identity_init,
    )
    return ModelWrapper(module, name="umx").to(resolve_device(device)).eval()


def make_dcunet(
    sample_rate=48000,
    architecture="Large-DCUNet-20",
    stft_kernel_size=512,
    fix_length_mode="pad",
    num_bins=1025,
    norm_type="bN",
    identity_init=False,
    device=None,
    **_ignored,
) -> ModelWrapper:
    module = DCUNet(
        architecture=architecture,
        stft_kernel_size=stft_kernel_size,
        fix_length_mode=fix_length_mode,
        norm_type=norm_type,
        identity_init=identity_init,
    )
    return ModelWrapper(module, name="dcunet").to(resolve_device(device)).eval()


def make_dptnet(
    sample_rate=48000,
    n_src=1,
    in_chan=64,
    out_chan=64,
    chunk_size=100,
    n_repeats=2,
    fb_name="free",
    kernel_size=16,
    n_filters=64,
    stride=8,
    num_bins=1025,
    device=None,
    **_ignored,
) -> ModelWrapper:
    module = DPTNet(
        n_src=n_src,
        in_chan=in_chan,
        out_chan=out_chan,
        chunk_size=chunk_size,
        n_repeats=n_repeats,
        kernel_size=kernel_size,
        n_filters=n_filters,
        stride=stride,
    )
    return ModelWrapper(module, name="dptnet").to(resolve_device(device)).eval()


def make_demucs(
    sample_rate=48000,
    sources=("mixture",),
    audio_channels=1,
    nfft=4096,
    channels=48,
    depth=6,
    identity_init=False,
    device=None,
    **_ignored,
) -> ModelWrapper:
    # identity_init: zero the final transposed convs and add the input
    # back in the wrapper, so the model starts as an exact passthrough
    module = HDemucs(
        sources=tuple(sources),
        audio_channels=audio_channels,
        channels=channels,
        nfft=nfft,
        depth=depth,
        zero_final=bool(identity_init),
    )
    wrapper = ModelWrapper(module, name="demucs", residual=bool(identity_init))
    return wrapper.to(resolve_device(device)).eval()


MODEL_REGISTRY = {
    "tcn": make_tcn,
    "umx": make_umx,
    "dcunet": make_dcunet,
    "dptnet": make_dptnet,
    "demucs": make_demucs,
}


def make_model(name: str, **kwargs) -> ModelWrapper:
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    fn = MODEL_REGISTRY[name]
    # every factory takes **_ignored so that surplus config keys do not
    # crash; name what is dropped, since a swallowed key can size the
    # wrong network without a sound
    named = {
        p.name
        for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    }
    extra = sorted(set(kwargs) - named)
    if extra:
        log.warning("model %r ignores network config keys: %s", name, extra)
    return fn(**kwargs)


__all__ = ["TCN", "Cnn14", "DCUNet", "DPTNet", "HDemucs", "ModelWrapper",
           "UMXSeparator", "make_model", "make_cnn14", "make_dcunet",
           "make_demucs", "make_dptnet", "make_tcn", "make_umx",
           "MODEL_REGISTRY"]
