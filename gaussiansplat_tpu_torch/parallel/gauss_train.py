"""Training with gaussian-axis-sharded parameters.

Each rank holds one block of the model (`shard_model`) and an Adam over
that block only; the forward and backward run through the all_to_all
payload exchange of gauss_shard.py, whose backward delivers each
parameter's gradient to the rank that owns it. So the optimizer step is
local to every rank and no gradient collective is needed (the
data/tile-sharded step of parallel/train.py all-reduces its gradients
instead). Every rank computes the same loss on the gathered frame and
calls `backward()`, which the backward collectives need.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RasterConfig, TrainConfig
from ..models.gaussians import GaussianModel
from ..ops.camera import Camera
from ..train.loss import photometric_loss, psnr
from ..train.trainer import TrainState, init_train_state, set_position_lr
from ..utils.logging import span
from .gauss_shard import GAUSS_AXIS, make_gauss_sharded_render, shard_model
from .mesh import Mesh, all_reduce
from .train import _background


def init_gauss_sharded_state(model: GaussianModel, mesh: Mesh,
                             cfg: TrainConfig, extent: float) -> TrainState:
    """Shard the model over the gauss axis, then build the train state of
    this rank's block (its Adam moments and densify statistics cover the
    block only)."""
    return init_train_state(shard_model(model, mesh), cfg, extent)


def make_gauss_sharded_train_step(
    mesh: Mesh,
    raster_cfg: RasterConfig,
    cfg: TrainConfig,
    width: int,
    height: int,
    sh_degree: int,
    send_cap: Optional[int] = None,
    impl: Optional[str] = None,
    return_grads: bool = False,
):
    """Build `step(state, camera, gt) -> (state, metrics)` over sharded
    parameters (`init_gauss_sharded_state`). `gt` is the full (H, W, 3)
    target, the same on every rank. Metrics are 0-d tensors on the model's
    device: `loss`, `psnr`, `overflow`, `pack_overflow` (the exchange's
    share of `overflow`) and `max_chunks` over the gauss group, and
    `num_alive` summed over it (with `return_grads`, also this rank's
    gradient block). The step is the span `gs.step` (utils/logging.py),
    as the one-card step's: `gs.render`'s spans, `gs.loss`, `gs.backward`
    (with `gs.raster.bwd`, `gs.gather.bwd`, `gs.exchange.bwd` and
    `gs.strips` inside) and `gs.optimizer`."""
    render_fn = make_gauss_sharded_render(
        mesh, raster_cfg, width, height, sh_degree, send_cap=send_cap,
        impl=impl)
    group = mesh.group(GAUSS_AXIS)

    def step(state: TrainState, camera: Camera, gt: torch.Tensor):
        with span("gs.step", state.model.device):
            return _step(state, camera, gt)

    def _step(state: TrainState, camera: Camera, gt: torch.Tensor):
        model, optimizer = state.model, state.optimizer
        device = model.device
        # Drawn alike on every rank: one background for the whole frame.
        background = _background(cfg, state.step, 0, device)
        gt = gt.to(device)

        optimizer.zero_grad(set_to_none=True)
        offset = torch.zeros((model.capacity, 2), dtype=torch.float32,
                             device=device, requires_grad=True)
        img, _, aux = render_fn(model, camera, background,
                                mean2d_offset=offset, with_aux=True)
        with span("gs.loss"):
            loss = photometric_loss(img, gt, cfg.ssim_lambda)
        with span("gs.backward"):
            loss.backward()

        with span("gs.optimizer"):
            set_position_lr(optimizer, cfg, state.extent, state.step)
            optimizer.step()
        state.densify.update(offset.grad, aux["radii"])
        state.step += 1
        with torch.no_grad():
            metrics = dict(
                loss=loss.detach(),
                psnr=psnr(img, gt),
                overflow=aux["overflow"],
                pack_overflow=aux["pack_overflow"],
                max_chunks=aux["max_chunks_needed"],
                num_alive=all_reduce(model.num_alive, "sum", group),
            )
        if return_grads:
            metrics["grads"] = {g["name"]: g["params"][0].grad.clone()
                                for g in optimizer.param_groups}
        return state, metrics

    return step
