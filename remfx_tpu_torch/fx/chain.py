"""RandomAudioEffectsChannel — the full randomised mixing channel.

Counterpart of ``remfx_tpu/fx/chain.py``; parity target reference
``RandomAudioEffectsChannel`` (remfx/effects.py:632-696): a Compose of
RandomApply(effect, p) in the fixed order EQ → distortion → delay → chorus
→ phaser → compressor → reverb → widener → limiter → volume automation,
then LUFS normalisation (−32 LUFS by default). The widener needs two
channels and is skipped on mono input.

The JAX channel decides per example with ``lax.cond``. Here each stage
draws a ``(B,)`` decision and parameters for every row, then renders only
the rows whose decision is true, gathered into a sub-batch and scattered
back, so a stage that no row drew costs nothing. ``render_batch`` takes
explicit decisions and parameters; ``__call__`` draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import torch

from remfx_tpu_torch.fx import chorus, compressor, delay, distortion, eq, phaser
from remfx_tpu_torch.fx import reverb as reverb_mod
from remfx_tpu_torch.fx.dynamics import (LoudnessNormalize, make_limiter,
                                         make_stereo_widener, make_volume_automation)
from remfx_tpu_torch.utils.device import resolve_device


class RandomAudioEffectsChannel:
    DEFAULT_PROBS = {
        "parametric_eq": 0.7,
        "distortion": 0.01,
        "delay": 0.1,
        "chorus": 0.01,
        "phaser": 0.01,
        "compressor": 0.4,
        "reverb": 0.2,
        "stereo_widener": 0.3,
        "limiter": 0.3,
        "volume_automation": 0.7,
    }

    def __init__(self, sample_rate, target_lufs_db: float = -32.0, device=None,
                 **probs):
        self.sample_rate = sample_rate
        self.probs = dict(self.DEFAULT_PROBS)
        for k, v in probs.items():
            name = k[: -len("_prob")] if k.endswith("_prob") else k
            if name not in self.probs:
                raise ValueError(f"unknown effect prob {k}")
            self.probs[name] = v
        d = resolve_device(device)
        self.effects = {
            "parametric_eq": eq.make(sample_rate, device=d),
            "distortion": distortion.make(sample_rate, device=d),
            "delay": delay.make(sample_rate, device=d),
            "chorus": chorus.make(sample_rate, device=d),
            "phaser": phaser.make(sample_rate, device=d),
            "compressor": compressor.make(sample_rate, device=d),
            "reverb": reverb_mod.make(sample_rate, device=d),
            "stereo_widener": make_stereo_widener(sample_rate, device=d),
            "limiter": make_limiter(sample_rate, device=d),
            "volume_automation": make_volume_automation(sample_rate, device=d),
        }
        self.normalize = LoudnessNormalize(sample_rate, target_lufs_db)

    def stages(self, channels: int) -> list[str]:
        """The stages in order for input of ``channels`` channels."""
        return [n for n in self.effects if n != "stereo_widener" or channels == 2]

    def sample(self, generator: torch.Generator, n: int, channels: int):
        """Per stage, ``n`` decisions (``(n,)`` bool, on the CPU) and ``n``
        rows of parameters -> ``(apply, params)``, dicts by stage name."""
        apply, params = {}, {}
        for name in self.stages(channels):
            apply[name] = torch.rand(n, generator=generator) < self.probs[name]
            params[name] = self.effects[name].sample_params(generator, n)
        return apply, params

    def render_batch(self, xb: torch.Tensor, apply: dict, params: dict) -> torch.Tensor:
        """``xb (B, C, T)``; for every stage, ``apply[name] (B,)`` bool and
        ``params[name]``, tensors of leading dimension B."""
        for name in self.stages(xb.shape[1]):
            rows = torch.as_tensor(apply[name]).cpu().nonzero().flatten()
            if rows.numel() == 0:
                continue
            sub = {k: v[rows.to(v.device)] for k, v in params[name].items()}
            idx = rows.to(xb.device)
            y = self.effects[name].render_batch(xb.index_select(0, idx), sub)
            xb = xb.index_copy(0, idx, y.to(xb.dtype))
        return self.normalize(xb)

    def __call__(self, generator: torch.Generator, xb: torch.Tensor) -> torch.Tensor:
        apply, params = self.sample(generator, xb.shape[0], xb.shape[1])
        return self.render_batch(xb, apply, params)
