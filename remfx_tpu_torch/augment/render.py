"""Effect-chain rendering with label semantics: the data-synthesis path.

Counterpart of ``remfx_tpu/augment/render.py``, itself the on-device form
of the reference's ``EffectDataset.process_effects`` (remfx/datasets.py:
521-585):

  1. draw a subset and order of ``effects_to_keep``, the count as
     ``round((r1-r2)*U + r2)`` (the reference's endpoint half-weighting,
     datasets.py:529-531), and apply each effect with a LUFS
     normalisation (-20) after it -> "dry";
  2. the same for ``effects_to_remove``, on top of dry -> "wet";
  3. multi-hot labels in the canonical ``ALL_EFFECTS`` order;
  4. a final LUFS normalisation of both; where MR-STFT(wet, dry) < 1e-3,
     draw the effects again (at most ``max_redraws`` times), re-applying
     the kept effects onto the already-effected dry (reference quirk #4).

``render_batch`` is split in two: ``draw`` (host side: the per-row plan
of which effect runs in which slot, and each row's parameters, all from
one ``torch.Generator``) and ``apply`` (plan and batch -> dry and wet).

Dispatch ``"dense"`` (the default) renders, per slot and per effect,
exactly the rows assigned to it, as one batched call, and writes them
back. (The JAX package pads these sub-batches to a power of two to bound
its jitted shapes; eager PyTorch has no compile units, and the padded
rows only repeat their row's own draw.) ``"switch"`` runs ``render``, the
single-example path, over the rows one by one: the reference's
per-example semantics, with other draws from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from remfx_tpu_torch import ALL_EFFECTS
from remfx_tpu_torch.fx import make_effect
from remfx_tpu_torch.losses import multi_resolution_stft_loss
from remfx_tpu_torch.ops.loudness import loudness_normalize
from remfx_tpu_torch.utils.device import resolve_device

STFT_THRESH = 1e-3  # reference remfx/datasets.py:19


@dataclass
class Step:
    """One effect on some rows: ``rows`` (sorted indices into the batch)
    and their parameters, each of leading dimension ``len(rows)``."""
    name: str
    rows: np.ndarray
    params: dict


@dataclass
class StagePlan:
    """The kept or removed stage of a batch: multi-hot ``labels (B, 5)`` and
    the steps in the order they run (slot by slot)."""
    labels: np.ndarray
    steps: list = field(default_factory=list)


@dataclass
class Plan:
    keep: StagePlan
    remove: StagePlan


class EffectChainRenderer:
    """Chain renderer for a fixed configuration.

    ``render_batch(generator, x)``: ``x (B, C, T)`` -> normalised dry and
    wet ``(B, C, T)`` and their labels ``(B, 5)``. ``render(generator, x)``:
    one example ``(C, T)``. ``effect_overrides`` maps an effect name to its
    range overrides (the cfg/effects/all.yaml surface). ``device=None``
    is the card; ``x`` must lie on the renderer's device.
    """

    def __init__(
        self,
        sample_rate: int,
        effects_to_keep: tuple[str, ...] = (),
        effects_to_remove: tuple[str, ...] = (),
        num_kept_effects: tuple[int, int] = (0, 0),
        num_removed_effects: tuple[int, int] = (0, 0),
        shuffle_kept_effects: bool = True,
        shuffle_removed_effects: bool = False,
        target_lufs_db: float = -20.0,
        effect_overrides: dict | None = None,
        max_redraws: int = 4,
        stft_check: bool = True,
        dispatch: str = "dense",
        device=None,
    ):
        if dispatch not in ("dense", "switch"):
            raise ValueError(f"dispatch must be 'dense' or 'switch', got {dispatch!r}")
        overrides = effect_overrides or {}
        self.sample_rate = int(sample_rate)
        self.effects_to_keep = tuple(effects_to_keep)
        self.effects_to_remove = tuple(effects_to_remove)
        self.num_kept_effects = tuple(num_kept_effects)
        self.num_removed_effects = tuple(num_removed_effects)
        self.shuffle_kept_effects = shuffle_kept_effects
        self.shuffle_removed_effects = shuffle_removed_effects
        self.target_lufs_db = target_lufs_db
        self.max_redraws = max_redraws
        self.stft_check = stft_check
        self.dispatch = dispatch
        self.device = resolve_device(device)
        for name in self.effects_to_keep + self.effects_to_remove:
            if name not in ALL_EFFECTS:
                raise ValueError(f"Effect {name!r} not found in ALL_EFFECTS {ALL_EFFECTS}")
        self._fx = {
            name: make_effect(name, self.sample_rate, device=self.device,
                              **overrides.get(name, {}))
            for name in set(self.effects_to_keep + self.effects_to_remove)
        }

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """Each example of ``x (B, C, T)`` to the target loudness."""
        return loudness_normalize(x, self.sample_rate, self.target_lufs_db)

    # ------------------------------------------------------------- draw

    def _draw_stage(self, generator, batch, names, shuffle, num_range) -> StagePlan:
        plan = StagePlan(np.zeros((batch, len(ALL_EFFECTS)), np.float32))
        n_cand = len(names)
        if n_cand == 0:
            return plan
        if shuffle:
            perms = np.stack([torch.randperm(n_cand, generator=generator).numpy()
                              for _ in range(batch)])
        else:
            perms = np.tile(np.arange(n_cand), (batch, 1))
        r1, r2 = num_range
        u = torch.rand(batch, generator=generator, dtype=torch.float32).numpy()
        counts = np.round((r1 - r2) * u + r2).astype(np.int32)
        slot_effect = np.where(np.arange(n_cand)[None, :] < counts[:, None], perms, -1)
        for s in range(n_cand):
            for li, name in enumerate(names):
                rows = np.nonzero(slot_effect[:, s] == li)[0]
                if rows.size == 0:
                    continue
                plan.labels[rows, ALL_EFFECTS.index(name)] = 1.0
                params = self._fx[name].sample_params(generator, rows.size)
                plan.steps.append(Step(name, rows, params))
        return plan

    def draw(self, generator: torch.Generator, batch: int) -> Plan:
        """The kept and removed stages' plans for ``batch`` rows."""
        keep = self._draw_stage(generator, batch, self.effects_to_keep,
                                self.shuffle_kept_effects, self.num_kept_effects)
        remove = self._draw_stage(generator, batch, self.effects_to_remove,
                                  self.shuffle_removed_effects, self.num_removed_effects)
        return Plan(keep, remove)

    # ------------------------------------------------------------ apply

    def _apply_stage(self, x: torch.Tensor, stage: StagePlan) -> torch.Tensor:
        for step in stage.steps:
            rows = torch.as_tensor(step.rows, device=x.device)
            y = self._fx[step.name].render_batch(x[rows], step.params)
            x = x.index_copy(0, rows, self.normalize(y.to(x.dtype)))
        return x

    def apply(self, x: torch.Tensor, plan: Plan) -> tuple[torch.Tensor, torch.Tensor]:
        """``x (B, C, T)`` through the plan -> (dry, wet), before the final
        normalisation."""
        dry = self._apply_stage(x, plan.keep)
        return dry, self._apply_stage(dry, plan.remove)

    # ----------------------------------------------------------- render

    def stft_distance(self, a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
        """MR-STFT loss of each row of ``a`` against the same row of ``b``."""
        return np.array([multi_resolution_stft_loss(a[i:i + 1], b[i:i + 1]).item()
                         for i in range(a.shape[0])])

    def _render_dense(self, generator, x):
        plan = self.draw(generator, x.shape[0])
        dry, wet = self.apply(x, plan)
        norm_dry, norm_wet = self.normalize(dry), self.normalize(wet)
        dry_labels, wet_labels = plan.keep.labels, plan.remove.labels
        if self.stft_check and self.effects_to_remove:
            for _ in range(self.max_redraws):
                dist = self.stft_distance(norm_wet, norm_dry)
                bad = (dist < STFT_THRESH) & (wet_labels.sum(axis=1) > 0)
                if not bad.any():
                    break
                # reference quirk #4: draw again from the already-effected
                # dry; only the failing rows render again
                sel = np.nonzero(bad)[0]
                rows = torch.as_tensor(sel, device=x.device)
                plan = self.draw(generator, sel.size)
                dry2, wet2 = self.apply(dry[rows], plan)
                dry = dry.index_copy(0, rows, dry2)
                norm_dry = norm_dry.index_copy(0, rows, self.normalize(dry2))
                norm_wet = norm_wet.index_copy(0, rows, self.normalize(wet2))
                dry_labels, wet_labels = dry_labels.copy(), wet_labels.copy()
                dry_labels[sel] = plan.keep.labels
                wet_labels[sel] = plan.remove.labels
        return (norm_dry, norm_wet, torch.as_tensor(dry_labels, device=x.device),
                torch.as_tensor(wet_labels, device=x.device))

    def _check_input(self, x: torch.Tensor, dims: int):
        if x.dim() != dims:
            raise ValueError(f"expected a {dims}-d input, got shape {tuple(x.shape)}")
        if x.device.type != self.device.type:
            raise ValueError(f"input on {x.device}, renderer on {self.device}")

    def render(self, generator: torch.Generator, x: torch.Tensor):
        """One clean chunk ``x (C, T)`` -> (dry, wet, dry_labels, wet_labels),
        normalised as the reference's normalized_dry / normalized_wet
        (datasets.py:577-578)."""
        self._check_input(x, 2)
        return tuple(t[0] for t in self._render_dense(generator, x[None]))

    def render_batch(self, generator: torch.Generator, x: torch.Tensor):
        """``x (B, C, T)`` -> batched (dry, wet, dry_labels, wet_labels)."""
        self._check_input(x, 3)
        if self.dispatch == "switch":
            rows = [self.render(generator, xi) for xi in x]
            return tuple(torch.stack(t) for t in zip(*rows))
        return self._render_dense(generator, x)
