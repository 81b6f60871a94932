"""Effects registry of the port.

Counterpart of ``remfx_tpu/fx/__init__.py``. The canonical five (label
order fixed by ``remfx_tpu_torch.ALL_EFFECTS``): reverb, chorus, delay,
distortion, compressor; and the extras parametric_eq, sox_reverb,
phaser, limiter, stereo_widener and volume_automation.
``RandomAudioEffectsChannel`` (``fx/chain.py``) chains all of them but
sox_reverb.
"""

from remfx_tpu_torch.fx import chorus as _chorus
from remfx_tpu_torch.fx import compressor as _compressor
from remfx_tpu_torch.fx import delay as _delay
from remfx_tpu_torch.fx import distortion as _distortion
from remfx_tpu_torch.fx import eq as _eq
from remfx_tpu_torch.fx import phaser as _phaser
from remfx_tpu_torch.fx import reverb as _reverb
from remfx_tpu_torch.fx import sox_reverb as _sox_reverb
from remfx_tpu_torch.fx.base import RandomEffect
from remfx_tpu_torch.fx.chain import RandomAudioEffectsChannel
from remfx_tpu_torch.fx.dynamics import (
    LoudnessNormalize,
    make_limiter,
    make_stereo_widener,
    make_volume_automation,
)


_FACTORIES = {
    "reverb": _reverb.make,
    "chorus": _chorus.make,
    "delay": _delay.make,
    "distortion": _distortion.make,
    "compressor": _compressor.make,
    "parametric_eq": _eq.make,
    "sox_reverb": _sox_reverb.make,
    "phaser": _phaser.make,
    "limiter": make_limiter,
    "stereo_widener": make_stereo_widener,
    "volume_automation": make_volume_automation,
}


def make_effect(name: str, sample_rate, device=None, **overrides) -> RandomEffect:
    """A randomised effect by canonical name, with range overrides (the
    cfg/effects/all.yaml surface); its parameters land on ``device``
    (``None``: the card)."""
    if name not in _FACTORIES:
        raise ValueError(f"unknown effect {name!r}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](sample_rate, device=device, **overrides)


__all__ = [
    "RandomEffect",
    "RandomAudioEffectsChannel",
    "LoudnessNormalize",
    "make_effect",
]
