"""Data synthesis: the effect-chain renderer."""

from remfx_tpu_torch.augment.render import STFT_THRESH, EffectChainRenderer

__all__ = ["EffectChainRenderer", "STFT_THRESH"]
