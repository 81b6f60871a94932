"""Effects registry of the port.

Counterpart of ``remfx_tpu/fx/__init__.py``. The canonical five (label
order fixed by ``remfx_tpu_torch.ALL_EFFECTS``): reverb, chorus, delay,
distortion, compressor; and the extras parametric_eq, limiter,
stereo_widener and volume_automation. ``phaser`` and ``sox_reverb`` are
not ported yet (ROADMAP §A7) and raise; ``RandomAudioEffectsChannel``
waits for ``fx/chain.py``.
"""

from remfx_tpu_torch.fx import chorus as _chorus
from remfx_tpu_torch.fx import compressor as _compressor
from remfx_tpu_torch.fx import delay as _delay
from remfx_tpu_torch.fx import distortion as _distortion
from remfx_tpu_torch.fx import eq as _eq
from remfx_tpu_torch.fx import reverb as _reverb
from remfx_tpu_torch.fx.base import RandomEffect
from remfx_tpu_torch.fx.dynamics import (
    LoudnessNormalize,
    make_limiter,
    make_stereo_widener,
    make_volume_automation,
)


def _not_ported(name: str):
    def make(sample_rate, device=None, **overrides):
        raise NotImplementedError(
            f"effect {name!r} is not ported yet (ROADMAP.md §A7); use the JAX package")
    return make


_FACTORIES = {
    "reverb": _reverb.make,
    "chorus": _chorus.make,
    "delay": _delay.make,
    "distortion": _distortion.make,
    "compressor": _compressor.make,
    "parametric_eq": _eq.make,
    "sox_reverb": _not_ported("sox_reverb"),
    "phaser": _not_ported("phaser"),
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


__all__ = ["RandomEffect", "LoudnessNormalize", "make_effect"]
