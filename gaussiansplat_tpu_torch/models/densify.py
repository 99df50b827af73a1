"""Adaptive density control: clone / split / prune / opacity reset.

The 3DGS schedule on a fixed-capacity model with an `alive` mask: new
gaussians are written into dead slots (the k-th requester takes the k-th
dead slot in index order; requests beyond the free slots are dropped and
counted), and pruning only clears `alive`. Every pass writes the model's
own `nn.Parameter`s and its `alive` buffer in place, under
`torch.no_grad()`, so an optimizer that holds those parameters keeps
stepping them; the trainer resets the Adam moments of the slots a pass
changed (train/trainer.make_densify_fn).

The densification statistics are accumulated by the trainer: per slot, the
norm of the loss gradient with respect to its screen-space centre (the
gradient of the zero `mean2d_offset` that `render` takes), the number of
steps it was visible and its largest screen radius.

Boolean-mask indexing here reads counts back to the host: these passes run
at schedule points (every `densify_every` steps), never inside a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..ops.quaternion import normalize, quat_to_rotmat
from .gaussians import PARAM_NAMES, GaussianModel

F32 = torch.float32


@dataclasses.dataclass
class DensifyState:
    """Running densification statistics, reset after every densify step."""

    grad2d_sum: torch.Tensor    # (C,) f32 sum of ||d loss / d mean2d|| over steps
    grad2d_count: torch.Tensor  # (C,) int32 steps where the gaussian was visible
    max_radii: torch.Tensor     # (C,) int32 max screen radius since the last reset

    @classmethod
    def zeros(cls, capacity: int, device="cuda") -> "DensifyState":
        return cls(
            grad2d_sum=torch.zeros((capacity,), dtype=torch.float32, device=device),
            grad2d_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
            max_radii=torch.zeros((capacity,), dtype=torch.int32, device=device),
        )

    @torch.no_grad()
    def update(self, grad2d: torch.Tensor, radii: torch.Tensor) -> "DensifyState":
        """Accumulate one step, in place: grad2d (C, 2) loss gradient w.r.t.
        screen position; radii (C,) int32 screen radii (0 = invisible).
        Returns self."""
        visible = radii > 0
        norm = torch.linalg.vector_norm(grad2d, dim=-1)
        self.grad2d_sum += torch.where(visible, norm, torch.zeros_like(norm))
        self.grad2d_count += visible.to(torch.int32)
        torch.maximum(self.max_radii, radii.to(torch.int32), out=self.max_radii)
        return self


def _f32_product(a: float, b: float, device) -> torch.Tensor:
    """a * b rounded as float32 operands multiplied in float32 (the
    reference's `cfg.x * extent` with a float32 extent)."""
    return (torch.tensor(a, dtype=F32, device=device)
            * torch.tensor(b, dtype=F32, device=device))


@torch.no_grad()
def _place_into_dead_slots(model: GaussianModel, want_new: torch.Tensor,
                           new_fields: Dict[str, torch.Tensor]) -> int:
    """Copy the `new_fields` rows of the requesting slots (want_new, (C,)
    bool) into dead slots, in place: the k-th requester in index order
    takes the k-th dead slot. Returns the number of requests dropped for
    want of a free slot."""
    src = torch.nonzero(want_new).squeeze(1)
    dst = torch.nonzero(~model.alive).squeeze(1)
    k = min(src.numel(), dst.numel())
    src, dst = src[:k], dst[:k]
    for name, vals in new_fields.items():
        getattr(model, name)[dst] = vals[src]
    model.alive[dst] = True
    return int(want_new.sum()) - k


def _densify(model: GaussianModel, state: DensifyState, cfg: TrainConfig,
             scene_extent: float, eps: torch.Tensor, eps2: torch.Tensor
             ) -> Tuple[GaussianModel, DensifyState, dict]:
    """`densify_step` with its two standard-normal (C, 3) draws given:
    `eps` samples the split copies, `eps2` resamples the split originals."""
    device = model.device
    avg_grad = state.grad2d_sum / torch.clamp(state.grad2d_count, min=1)
    eligible = (state.grad2d_count > 0) & model.alive
    if cfg.densify_target_fraction is None:
        high_grad = (avg_grad > cfg.densify_grad_thresh) & eligible
    else:
        # Exactly the top `fraction` of the eligible slots by average
        # gradient (ties by slot index): k = max(fraction * m, 1) in
        # float32, truncated.
        m = eligible.sum(dtype=torch.int32)
        k = torch.clamp(
            torch.tensor(cfg.densify_target_fraction, dtype=F32, device=device)
            * m.to(F32), min=1.0).to(torch.int32)
        key = torch.where(eligible, avg_grad,
                          torch.full_like(avg_grad, -math.inf))
        order = torch.argsort(-key, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(model.capacity, device=device)
        high_grad = (rank < k) & (m > 0) & eligible
    max_scale = torch.exp(torch.max(model.log_scales.detach(), dim=-1).values)
    small = max_scale <= _f32_product(cfg.densify_scale_thresh, scene_extent,
                                      device)
    clone_mask = high_grad & small & model.alive
    split_mask = high_grad & ~small & model.alive

    # Clones: exact copies (they drift apart under the optimizer).
    clone_dropped = _place_into_dead_slots(
        model, clone_mask, {k: getattr(model, k).detach() for k in PARAM_NAMES})

    # Splits: a sample into a dead slot, then the original shrunk and
    # resampled. rot and scales are read after the clones were placed.
    means = model.means.detach()
    log_scales = model.log_scales.detach()
    rot = quat_to_rotmat(normalize(model.quats.detach()))
    scales = torch.exp(log_scales)
    sample = means + torch.einsum("nij,nj->ni", rot, eps * scales)
    new_log_scales = log_scales - torch.log(
        torch.tensor(cfg.split_factor, dtype=F32, device=device))
    fields = {k: getattr(model, k).detach() for k in PARAM_NAMES}
    fields.update(means=sample, log_scales=new_log_scales)
    split_dropped = _place_into_dead_slots(model, split_mask, fields)
    sample2 = means + torch.einsum("nij,nj->ni", rot, eps2 * scales)
    with torch.no_grad():
        model.means[split_mask] = sample2[split_mask]
        model.log_scales[split_mask] = new_log_scales[split_mask]

    info = dict(
        cloned=int(clone_mask.sum()) - clone_dropped,
        split=int(split_mask.sum()) - split_dropped,
        dropped=clone_dropped + split_dropped,
        # (C,) bool: slots whose parameters changed in place (the split
        # originals). The trainer resets their Adam moments too and pops
        # this key before logging.
        touched=split_mask,
    )
    return model, DensifyState.zeros(model.capacity, device=device), info


@torch.no_grad()
def densify_step(model: GaussianModel, state: DensifyState,
                 generator: torch.Generator, cfg: TrainConfig,
                 scene_extent: float) -> Tuple[GaussianModel, DensifyState, dict]:
    """One clone + split pass (3DGS `densify_and_clone` / `densify_and_split`),
    in place on the model. Clone: high-gradient, small-scale gaussians are
    duplicated. Split: high-gradient, large-scale gaussians get a sample of
    their own distribution in a dead slot and are resampled themselves,
    both with scales / split_factor. The two normal draws come from
    `generator` (on the model's device). Returns (model, fresh statistics,
    info with `cloned`, `split`, `dropped` and the `touched` mask)."""
    shape, dev = model.means.shape, generator.device
    eps = torch.randn(shape, generator=generator, device=dev, dtype=F32)
    eps2 = torch.randn(shape, generator=generator, device=dev, dtype=F32)
    return _densify(model, state, cfg, scene_extent, eps.to(model.device),
                    eps2.to(model.device))


@torch.no_grad()
def prune_step(model: GaussianModel, state: DensifyState, cfg: TrainConfig,
               scene_extent: float, prune_big_screen: bool = False,
               max_screen_px: Optional[float] = None) -> Tuple[GaussianModel, dict]:
    """Kill gaussians that are nearly transparent or, with
    `prune_big_screen`, degenerately large in world space or on screen
    (3DGS `prune_points`), in place; dead slots return to the free pool.
    `max_screen_px` is the screen-radius threshold in pixels (None turns
    the screen test off)."""
    opacity = torch.sigmoid(model.logit_opacities)
    kill = opacity < cfg.prune_opacity
    if prune_big_screen:
        max_scale = torch.exp(torch.max(model.log_scales, dim=-1).values)
        kill |= max_scale > _f32_product(cfg.prune_radius_frac, scene_extent,
                                         model.device)
        if max_screen_px is not None:
            kill |= state.max_radii.to(F32) > float(max_screen_px)
    pruned = int((model.alive & kill).sum())
    model.alive &= ~kill
    return model, dict(pruned=pruned)


@torch.no_grad()
def reset_opacity(model: GaussianModel, cfg: TrainConfig) -> GaussianModel:
    """Clamp the alive gaussians' opacity to at most `opacity_reset_value`
    (3DGS resets every 3k steps so pruning can reclaim floaters), in
    place."""
    v = math.log(cfg.opacity_reset_value / (1 - cfg.opacity_reset_value))
    logit = model.logit_opacities
    logit.copy_(torch.where(model.alive, torch.clamp(logit, max=v), logit))
    return model
