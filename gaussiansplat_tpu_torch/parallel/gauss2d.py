"""The (data, gauss) mesh: batched views over gaussian-sharded parameters.

Composes the two sharding axes into one grid, `gauss` the minor axis
(rank = data index * gauss + gauss index):

  * the `gauss` axis partitions the parameters and runs the strip
    all_to_all exchange of parallel/gauss_shard.py (memory scaling);
  * the `data` axis renders a DIFFERENT camera per data group (throughput
    scaling). Each rank's loss is its view's loss over n_data, so the sum
    over the data axis is the batch mean; one all-reduce over each gauss
    shard's data group sums the gradients, and every replica of a shard
    receives the same bits, so the replicas stay equal.

The reference gets that data-axis sum from shard_map's transpose of a
replicated input; here it is one explicit all-reduce per step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import RasterConfig, TrainConfig
from ..models.gaussians import GaussianModel
from ..ops.camera import Camera
from ..train.loss import photometric_loss, psnr
from ..train.trainer import TrainState, set_position_lr
from .gauss_shard import GAUSS_AXIS, make_gauss_sharded_render, shard_model
from .mesh import DATA_AXIS, Mesh, all_reduce, make_grid
from .render import _GatherStrips
from .train import _background, _flat, _unflat, camera_at


def make_mesh2d(data: int, gauss: int) -> Mesh:
    """The running world laid out as (data, gauss), gauss the minor axis.
    Every rank must call it; the world size must be data * gauss."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * gauss != world:
        raise ValueError(f"mesh {data}x{gauss} needs {data * gauss} devices, "
                         f"have {world}")
    return make_grid(data, gauss, GAUSS_AXIS)


def shard_model_2d(model: GaussianModel, mesh: Mesh) -> GaussianModel:
    """Gauss-axis sharded, data-axis replicated: this rank's gauss block."""
    return shard_model(model, mesh)


def make_gauss2d_render(
    mesh: Mesh,
    cfg: RasterConfig,
    width: int,
    height: int,
    sh_degree: int,
    send_cap: Optional[int] = None,
    impl: Optional[str] = None,
    send_fraction: float = 0.5,
):
    """Build `f(model, cameras, background) -> (images, aux)`: each data
    group renders the camera of its index of the stacked `cameras`
    (parallel.stack_cameras) over its gauss shards, and the (n_data,
    height, width, 3) batch is assembled data-major on every rank. The
    gradient of a loss that every rank computes alike on the batch is this
    rank's view's share: sum it over the data group (as
    `make_gauss2d_train_step` does). aux: `overflow` summed over both
    axes."""
    view_fn = make_gauss_sharded_render(
        mesh, cfg, width, height, sh_degree, send_cap=send_cap, impl=impl,
        send_fraction=send_fraction)
    data_group = mesh.group(DATA_AXIS)

    def f(model, cameras: Camera, background):
        img, _, aux = view_fn(model, camera_at(cameras, mesh.data_index),
                              background, with_aux=True)
        imgs = _GatherStrips.apply(img[None], data_group, mesh.data_index,
                                   list(range(mesh.data + 1)))
        overflow = all_reduce(aux["overflow"], "sum", data_group)
        return imgs, dict(overflow=overflow)

    return f


def make_gauss2d_train_step(
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
    """Build `step(state, cameras, gts) -> (state, metrics)`: one camera
    and (H, W, 3) target per data group (stacked on dim 0), the loss the
    batch mean, parameters and Adam moments sharded over `gauss` only (the
    state of `gauss_train.init_gauss_sharded_state` on this rank's block).
    Metrics: `loss` and `psnr` (batch means), `overflow` (summed over both
    axes) and `num_alive` (summed over the gauss group); with
    `return_grads`, this rank's summed gradient block."""
    view_fn = make_gauss_sharded_render(
        mesh, raster_cfg, width, height, sh_degree, send_cap=send_cap,
        impl=impl)
    ndata = mesh.data
    data_g, gauss_g = mesh.group(DATA_AXIS), mesh.group(GAUSS_AXIS)

    def step(state: TrainState, cameras: Camera, gts: torch.Tensor):
        model, optimizer = state.model, state.optimizer
        device = model.device
        d = mesh.data_index
        # One background for the batch, drawn alike on every rank.
        background = _background(cfg, state.step, 0, device)
        gt = gts[d].to(device)

        optimizer.zero_grad(set_to_none=True)
        img, _, aux = view_fn(model, camera_at(cameras, d), background,
                              with_aux=True)
        local = photometric_loss(img, gt, cfg.ssim_lambda) / ndata
        local.backward()

        with torch.no_grad():
            params = [p for g in optimizer.param_groups for p in g["params"]]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            summed = all_reduce(_flat(grads + [local.detach()]), "sum",
                                data_g)
            parts = _unflat(summed, grads + [local])
            for p, g in zip(params, parts):
                p.grad = g.clone()
            loss = parts[-1]
            view_psnr = all_reduce(psnr(img, gt), "sum", data_g) / ndata
            overflow = all_reduce(aux["overflow"], "sum", data_g)

        set_position_lr(optimizer, cfg, state.extent, state.step)
        optimizer.step()
        state.step += 1
        metrics = dict(loss=loss, psnr=view_psnr, overflow=overflow,
                       num_alive=all_reduce(model.num_alive, "sum", gauss_g))
        if return_grads:
            metrics["grads"] = {g["name"]: g["params"][0].grad.clone()
                                for g in optimizer.param_groups}
        return state, metrics

    return step
