"""One 3DGS training step: render -> L1 + DSSIM loss -> gradients -> Adam.

Per-parameter-group Adam with the 3DGS learning rates (the position lr
decays exponentially and scales with the scene extent), and the
densification statistics harvested through a zero `mean2d_offset` that
requires grad. The gradient runs through the K2 backward raster kernel and
the K3 segment reduce on the card, and through their plain versions on the
CPU. The model's parameters are updated in place by `torch.optim.Adam`.
Density control (`make_densify_fn`), evaluation and the `Trainer` loop are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..config import RasterConfig, TrainConfig
from ..models.densify import DensifyState
from ..models.gaussians import PARAM_NAMES, GaussianModel
from ..ops.camera import Camera
from ..render import render
from .loss import photometric_loss, psnr


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
    generator: torch.Generator   # random backgrounds
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
    kernels or their plain versions follow `raster_cfg.impl`."""

    def step_fn(state: TrainState, camera: Camera, gt: torch.Tensor,
                sh_degree: int):
        model, optimizer = state.model, state.optimizer
        device = model.device
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
        loss = photometric_loss(out.image, gt, cfg.ssim_lambda)
        loss.backward()

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
