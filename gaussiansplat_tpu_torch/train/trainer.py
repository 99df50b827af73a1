"""The 3DGS training loop: train step, density control, evaluation, `Trainer`.

A step renders, takes the L1 + DSSIM loss and its gradients and applies
per-parameter-group Adam with the 3DGS learning rates (the position lr
decays exponentially and scales with the scene extent); the densification
statistics are harvested through a zero `mean2d_offset` that requires grad.
The gradient runs through the K2 backward raster kernel and the K3 segment
reduce on the card, and through their plain versions on the CPU. The
model's parameters are updated in place by `torch.optim.Adam`, and density
control (models/densify.py) writes into the same parameters, so the
optimizer always holds the model's own tensors.

`Trainer.fit` runs the schedule: a per-epoch view shuffle, the SH degree
ramp, densify / prune passes in their window (with the Adam moments of the
changed slots reset), opacity resets, held-out evaluation with preview
PNGs, and checkpoints with resume. Steps leave their metrics on the device;
the host reads them only every `log_every` steps and at schedule points.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RasterConfig, TrainConfig
from ..models.densify import DensifyState, densify_step, prune_step, reset_opacity
from ..models.gaussians import PARAM_NAMES, GaussianModel, scene_extent
from ..ops.camera import Camera
from ..render import render
from ..utils.logging import span
from .loss import photometric_loss, psnr, ssim


def position_lr_schedule(cfg: TrainConfig, extent: float) -> Callable[[int], float]:
    """Exponential decay from lr_means to lr_means_final over the run, both
    scaled by the scene extent (3DGS's get_expon_lr_func)."""
    log_init = math.log(cfg.lr_means * extent)
    log_final = math.log(cfg.lr_means_final * extent)

    def sched(step: int) -> float:
        t = min(max(step / cfg.iterations, 0.0), 1.0)
        return math.exp(log_init * (1 - t) + log_final * t)

    return sched


def make_optimizer(model: GaussianModel, cfg: TrainConfig,
                   extent: float) -> torch.optim.Adam:
    """One Adam over the six parameter groups (named by `"name"`), 3DGS
    learning rates, eps 1e-15 as upstream. The `means` group starts at the
    schedule's step-0 rate; the train step resets it before every update."""
    lrs = dict(
        means=position_lr_schedule(cfg, extent)(0),
        quats=cfg.lr_quats,
        log_scales=cfg.lr_scales,
        logit_opacities=cfg.lr_opacities,
        sh_dc=cfg.lr_sh_dc,
        sh_rest=cfg.lr_sh_rest,
    )
    groups = [dict(params=[getattr(model, k)], lr=lrs[k], name=k)
              for k in PARAM_NAMES]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)


def set_position_lr(optimizer: torch.optim.Optimizer, cfg: TrainConfig,
                    extent: float, step: int) -> float:
    """Set the `means` group's lr to the schedule's value at `step` (the
    number of updates taken, optax's count); returns it."""
    lr = position_lr_schedule(cfg, extent)(step)
    for group in optimizer.param_groups:
        if group["name"] == "means":
            group["lr"] = lr
    return lr


@dataclasses.dataclass
class TrainState:
    model: GaussianModel
    optimizer: torch.optim.Adam
    densify: DensifyState
    step: int                    # updates taken (the schedule's count)
    generator: torch.Generator   # random backgrounds and split samples
    extent: float                # scene extent of the position lr


def init_train_state(model: GaussianModel, cfg: TrainConfig,
                     extent: float) -> TrainState:
    """A fresh state on the model's device, with its own optimizer."""
    extent = float(extent)
    return TrainState(
        model=model,
        optimizer=make_optimizer(model, cfg, extent),
        densify=DensifyState.zeros(model.capacity, device=model.device),
        step=0,
        generator=torch.Generator(device=model.device).manual_seed(cfg.seed),
        extent=extent,
    )


def make_train_step(raster_cfg: RasterConfig, cfg: TrainConfig) -> Callable:
    """Build the train step. `step_fn(state, camera, gt, sh_degree)` zeroes
    the gradients of the state's optimizer, renders with a zero (C, 2)
    `mean2d_offset` that requires grad, takes the loss and its backward,
    sets the position lr from the schedule, applies Adam in place,
    accumulates the densification statistics and counts the step. Returns
    (state, metrics); the metrics are 0-d tensors left on the device. The
    kernels or their plain versions follow `raster_cfg.impl`. The step is
    the span `gs.step` (utils/logging.py), with `gs.render`'s spans,
    `gs.loss`, `gs.backward` (`gs.raster.bwd` and `gs.gather.bwd` inside)
    and `gs.optimizer` under it."""

    def step_fn(state: TrainState, camera: Camera, gt: torch.Tensor,
                sh_degree: int):
        model, optimizer = state.model, state.optimizer
        device = model.device
        with span("gs.step", device):
            if cfg.random_background:
                background = torch.rand((3,), generator=state.generator,
                                        device=state.generator.device).to(device)
            elif cfg.white_background:
                background = torch.ones((3,), dtype=torch.float32, device=device)
            else:
                background = torch.zeros((3,), dtype=torch.float32, device=device)

            optimizer.zero_grad(set_to_none=True)
            offset = torch.zeros((model.capacity, 2), dtype=torch.float32,
                                 device=device, requires_grad=True)
            out = render(model, camera, raster_cfg, sh_degree=sh_degree,
                         background=background, mean2d_offset=offset)
            with span("gs.loss"):
                loss = photometric_loss(out.image, gt, cfg.ssim_lambda)
            with span("gs.backward"):
                loss.backward()

            with span("gs.optimizer"):
                set_position_lr(optimizer, cfg, state.extent, state.step)
                optimizer.step()

            state.densify.update(offset.grad, out.radii)
            state.step += 1
            with torch.no_grad():
                metrics = dict(
                    loss=loss.detach(),
                    psnr=psnr(out.image, gt),
                    num_pairs=out.num_pairs,
                    overflow=out.overflow,
                    max_chunks=out.max_chunks_needed,
                    num_alive=model.num_alive,
                )
        return state, metrics

    return step_fn


def reset_moments(optimizer: torch.optim.Optimizer, rows: torch.Tensor) -> None:
    """Zero the Adam moments (`exp_avg`, `exp_avg_sq`) of every parameter
    at the slots `rows` ((C,) bool), in place. The per-parameter step
    counts stay: the bias corrections and the position lr keep counting."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in st:
                        st[key][rows] = 0.0


def make_densify_fn(cfg: TrainConfig) -> Callable:
    """Build the densify / prune pass. `densify_fn(state, extent, prune_big,
    max_screen_px)` clones and splits (drawing from the state's
    generator), prunes (with `prune_big`, also by world size and by the
    screen radius `max_screen_px`, in pixels), resets the Adam moments of
    every slot whose `alive` flipped or that was split in place (3DGS
    replaces the optimizer rows of new points), and starts fresh
    statistics. Returns (state, info) with `cloned`, `split`, `dropped` and
    `pruned` as ints."""

    def densify_fn(state: TrainState, extent: float, prune_big: bool,
                   max_screen_px: Optional[float]):
        before_alive = state.model.alive.clone()
        model, dstate, info = densify_step(state.model, state.densify,
                                           state.generator, cfg, extent)
        touched = info.pop("touched")
        model, pinfo = prune_step(model, state.densify, cfg, extent, prune_big,
                                  max_screen_px=max_screen_px)
        info.update(pinfo)
        reset_moments(state.optimizer, (model.alive != before_alive) | touched)
        state.densify = dstate
        return state, info

    return densify_fn


def make_opacity_reset_fn(cfg: TrainConfig) -> Callable:
    def fn(state: TrainState) -> TrainState:
        reset_opacity(state.model, cfg)
        return state

    return fn


def make_eval_fn(raster_cfg: RasterConfig, cfg: TrainConfig) -> Callable:
    """Held-out view scorer: renders over the deterministic variant of the
    training background (black, or white with `white_background`) and
    returns (image, psnr, ssim) for one view, the scores as 0-d tensors."""
    value = 1.0 if cfg.white_background else 0.0

    @torch.no_grad()
    def eval_view(model: GaussianModel, camera: Camera, gt: torch.Tensor,
                  sh_degree: int):
        background = torch.full((3,), value, dtype=torch.float32,
                                device=model.device)
        out = render(model, camera, raster_cfg, sh_degree=sh_degree,
                     background=background)
        return out.image, psnr(out.image, gt), ssim(out.image, gt)

    return eval_view


def evaluate(
    eval_fn: Callable,
    model: GaussianModel,
    eval_views: Sequence[Tuple[Camera, torch.Tensor]],
    sh_degree: int,
    preview_path: Optional[str] = None,
) -> dict:
    """Score held-out views; optionally write a [prediction | ground truth]
    preview PNG of the first one. Returns mean metrics as floats."""
    psnrs, ssims = [], []
    for i, (cam, gt) in enumerate(eval_views):
        img, p, s = eval_fn(model, cam, gt, sh_degree)
        psnrs.append(float(p))
        ssims.append(float(s))
        if i == 0 and preview_path is not None:
            from ..utils.image import side_by_side, write_png

            write_png(preview_path, side_by_side(img, gt))
    n = max(len(psnrs), 1)
    return dict(
        eval_psnr=sum(psnrs) / n,
        eval_ssim=sum(ssims) / n,
        eval_views=float(len(psnrs)),
    )


@dataclasses.dataclass
class Trainer:
    """Runs the schedule: SH ramp, densify window, opacity resets, evals
    and checkpoints. The rasterizer backend follows `raster_cfg.impl`."""

    raster_cfg: RasterConfig
    cfg: TrainConfig

    def fit(
        self,
        model: GaussianModel,
        views: Sequence[Tuple[Camera, torch.Tensor]],
        log: Optional[Callable[[int, dict], None]] = None,
        iterations: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        resume: bool = False,
        eval_views: Optional[Sequence[Tuple[Camera, torch.Tensor]]] = None,
        preview_dir: Optional[str] = None,
        timer=None,
    ) -> Tuple[GaussianModel, dict]:
        """Train `model` in place on `views`. Returns (model, the last
        step's metrics as floats).

        Every `cfg.eval_every` steps (and at the end), held-out
        `eval_views` are rendered and scored (PSNR/SSIM) into a log row with
        kind='eval'; with `preview_dir` set, a [prediction | ground truth]
        PNG of the first eval view is written there. With `ckpt_dir`, the
        state is saved every `cfg.checkpoint_every` steps and at the end;
        `resume` restores the latest checkpoint and continues after its
        step (the view order restarts from `cfg.seed`); everything after
        the restore, the densify passes included, takes the checkpoint's
        scene extent, so a retry handed the model that a failed attempt
        trained (utils/resilience.run_resilient) equals a straight run bit
        for bit while the view order is in its first epoch. A `timer`
        (utils/logging.StageTimer) times every train step, densify pass,
        opacity reset and eval view."""
        cfg = self.cfg
        extent = float(scene_extent(model))
        state = init_train_state(model, cfg, extent)
        start_it = 0
        if ckpt_dir and resume:
            from ..utils.checkpoint import restore_checkpoint

            state, ck_step = restore_checkpoint(ckpt_dir, state)
            if ck_step is not None:
                start_it = ck_step
                # `model` may be the one a failed attempt trained: the
                # extent is the checkpoint's, as a straight run had it.
                extent = state.extent
        train_step = make_train_step(self.raster_cfg, cfg)
        densify_fn = make_densify_fn(cfg)
        opacity_reset_fn = make_opacity_reset_fn(cfg)
        eval_fn = make_eval_fn(self.raster_cfg, cfg)
        if timer is not None:
            train_step = timer.wrap("step", train_step)
            densify_fn = timer.wrap("densify", densify_fn)
            opacity_reset_fn = timer.wrap("opacity_reset", opacity_reset_fn)
            eval_fn = timer.wrap("eval_view", eval_fn)

        # Screen-space prune threshold from the render resolution.
        cam0 = views[0][0]
        max_screen_px = cfg.prune_screen_frac * max(int(cam0.width),
                                                    int(cam0.height))

        # Per-epoch view shuffle.
        rng = np.random.default_rng(cfg.seed)
        order = rng.permutation(len(views))

        iters = iterations if iterations is not None else cfg.iterations
        metrics = {}
        overflow_streak = 0
        t0 = time.time()
        for it in range(start_it + 1, iters + 1):
            j = (it - 1) % len(views)
            cam, gt = views[order[j]]
            if j == len(views) - 1:
                order = rng.permutation(len(views))
            sh_degree = min(
                cfg.sh_degree, (it - 1) // max(cfg.sh_increase_every, 1)
            )
            state, metrics = train_step(state, cam, gt, sh_degree)

            if (
                cfg.densify_start <= it <= cfg.densify_end
                and it % cfg.densify_every == 0
            ):
                state, dinfo = densify_fn(
                    state, extent, it > cfg.opacity_reset_every, max_screen_px)
                metrics.update(dinfo)

            if it % cfg.opacity_reset_every == 0 and it <= cfg.densify_end:
                state = opacity_reset_fn(state)

            if log is not None and (it % cfg.log_every == 0 or it == iters):
                m = {k: float(v) for k, v in metrics.items()}
                m["iters_per_sec"] = (it - start_it) / (time.time() - t0)
                log(it, m)

            # Pair-list overflow drops real work and corrupts gradients;
            # persistent overflow means pairs_per_gaussian is too small.
            if it % cfg.log_every == 0:
                if float(metrics.get("overflow", 0.0)) > 0:
                    overflow_streak += 1
                    warnings.warn(
                        f"binning overflow at step {it}: "
                        f"{float(metrics['overflow']):.0f} pairs dropped — "
                        "raise RasterConfig.pairs_per_gaussian",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    if overflow_streak >= 10:
                        raise RuntimeError(
                            "persistent binning overflow for "
                            f"{overflow_streak} consecutive log intervals; "
                            "training is dropping gaussians — raise "
                            "RasterConfig.pairs_per_gaussian"
                        )
                else:
                    overflow_streak = 0

            if eval_views and (it % cfg.eval_every == 0 or it == iters):
                erow = evaluate(
                    eval_fn, state.model, eval_views, sh_degree,
                    preview_path=(
                        f"{preview_dir}/preview_{it:06d}.png"
                        if preview_dir else None
                    ),
                )
                if log is not None:
                    log(it, dict(kind="eval", **erow))

            if ckpt_dir and (it % cfg.checkpoint_every == 0 or it == iters):
                from ..utils.checkpoint import save_checkpoint

                save_checkpoint(ckpt_dir, state, it)

        return state.model, {k: float(v) for k, v in metrics.items()}
