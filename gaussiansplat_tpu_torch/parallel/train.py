"""Sharded training step: data-parallel views x tile-parallel strips.

Each rank of the (data, tile) mesh renders the strip of tile rows of its
tile index, for the view of its data index (parallel/render.py: K4, K1;
backward K2, K3), takes its share of the loss and its gradients, and the
ranks sum them. Adam then steps on every rank with the same summed
gradients, so the replicas stay equal bit for bit.

The objective is exact, not strip-approximate: each strip exchanges the
SSIM_HALO = 5 boundary rows (the radius of the 11-px SSIM window) with its
tile neighbours before the SSIM map, so every window sees the pixels it
would see on one device; the first strip's top and the last strip's bottom
receive zeros, the zero padding of the single-device blur. The exchange is
an autograd Function whose backward returns the received rows' cotangents
to their owners. Both directions are one `all_gather` over the tile group,
which gloo and NCCL both implement.

Reductions, each over its group: gradients, the screen-position gradient
and the loss summed over both axes; radii and the longest tile list maxed
over both; the squared error summed over the tile axis (one view's MSE);
PSNR averaged over the data axis; overflow summed over both.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import RasterConfig, TrainConfig
from ..ops.camera import Camera
from ..train.loss import ssim_map
from ..train.trainer import TrainState, set_position_lr
from .mesh import DATA_AXIS, TILE_AXIS, Mesh, all_gather, all_reduce
from .render import (check_strips, render_strip, resolve_shard_impl,
                     strip_bounds, strip_pair_capacity)

# SSIM window radius: rows exchanged between neighbouring strips.
SSIM_HALO = 5


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """One Camera whose tensors carry a leading view axis (B, ...), from
    same-resolution cameras."""
    sizes = {(c.width, c.height) for c in cameras}
    if len(sizes) != 1:
        raise ValueError(f"cameras differ in resolution: {sorted(sizes)}")
    first = cameras[0]
    stacked = {f: torch.stack([getattr(c, f).to(first.device) for c in cameras])
               for f in ("R", "t", "fx", "fy", "cx", "cy")}
    return dataclasses.replace(first, **stacked)


def camera_at(cams: Camera, i: int) -> Camera:
    """View i of a stacked Camera."""
    return dataclasses.replace(
        cams, **{f: getattr(cams, f)[i] for f in ("R", "t", "fx", "fy", "cx", "cy")})


def pad_targets(gts: torch.Tensor, height: int, tile_size: int,
                ntile: int) -> torch.Tensor:
    """Pad (B, H, W, 3) ground truth with zero rows to the last row of the
    `ntile` strips (`strip_bounds`): the tile-aligned height."""
    rows = strip_bounds(-(-height // tile_size), ntile)[-1]
    return torch.nn.functional.pad(gts, (0, 0, 0, 0, 0, rows * tile_size - height))


class _HaloExchange(torch.autograd.Function):
    """(..., H, W, C) strip -> (..., H + 2 SSIM_HALO, W, C): the last rows of
    the strip above and the first rows of the strip below around it (zeros
    past the first and last strip). Backward: the cotangents of the
    received rows are sent back and added to their owners' rows."""

    @staticmethod
    def forward(ctx, x, group, index: int, ntile: int):
        h = SSIM_HALO
        ctx.group, ctx.index, ctx.ntile = group, index, ntile
        parts = all_gather(torch.stack([x[..., :h, :, :], x[..., -h:, :, :]]),
                           group)
        zeros = torch.zeros_like(x[..., :h, :, :])
        above = parts[index - 1][1] if index > 0 else zeros
        below = parts[index + 1][0] if index < ntile - 1 else zeros
        return torch.cat([above, x, below], dim=-3)

    @staticmethod
    def backward(ctx, g):
        h, index = SSIM_HALO, ctx.index
        parts = all_gather(torch.stack([g[..., :h, :, :], g[..., -h:, :, :]]),
                           ctx.group)
        dx = g[..., h:-h, :, :].clone()
        if index > 0:            # my first rows were the strip above's `below`
            dx[..., :h, :, :] += parts[index - 1][1]
        if index < ctx.ntile - 1:  # my last rows were the strip below's `above`
            dx[..., -h:, :, :] += parts[index + 1][0]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`_HaloExchange` over the mesh's tile group."""
    return _HaloExchange.apply(x, mesh.group(TILE_AXIS), mesh.tile_index,
                               mesh.tile)


def _background(cfg: TrainConfig, step: int, data_index: int,
                device) -> torch.Tensor:
    """The background policy of the single-device step; a random background
    is drawn from a generator seeded from (seed, step, data index), so every
    strip of one view draws the same colour and views differ."""
    if cfg.random_background:
        seed = int(np.random.SeedSequence(
            [cfg.seed, 7, step, data_index]).generate_state(1)[0])
        g = torch.Generator().manual_seed(seed)
        return torch.rand((3,), generator=g).to(device)
    value = 1.0 if cfg.white_background else 0.0
    return torch.full((3,), value, dtype=torch.float32, device=device)


def _flat(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def make_sharded_train_step(
    mesh: Mesh,
    raster_cfg: RasterConfig,
    cfg: TrainConfig,
    width: int,
    height: int,
    sh_degree: int,
    return_grads: bool = False,
    impl: Optional[str] = None,
):
    """Build `step(state, cams, gts) -> (state, metrics)`.

    `cams` is a stacked Camera of B = mesh.data views (`stack_cameras`) and
    `gts` their (B, Hp, W, 3) targets padded to the strip-aligned height
    (`pad_targets`); each rank takes the view of its data index and the rows
    of its strip. The state is `train.init_train_state`'s, its model and
    optimizer the same on every rank. Metrics are 0-d tensors on the
    model's device (with `return_grads`, also the summed gradients)."""
    ndata, ntile = mesh.data, mesh.tile
    ts = raster_cfg.tile_size
    bounds = check_strips(raster_cfg, height, ntile)
    shortest = min(b - a for a, b in zip(bounds[:-1], bounds[1:])) * ts
    if shortest < SSIM_HALO:
        raise ValueError(f"strips of {shortest} rows are shorter than the "
                         f"SSIM halo ({SSIM_HALO})")
    lam = cfg.ssim_lambda
    denom = float(height * width * 3)
    world, tile_g, data_g = (mesh.group(None), mesh.group(TILE_AXIS),
                             mesh.group(DATA_AXIS))

    def step(state: TrainState, cams: Camera, gts: torch.Tensor):
        model, optimizer = state.model, state.optimizer
        device = model.device
        d = mesh.data_index
        row0, rows = bounds[mesh.tile_index], bounds[mesh.tile_index + 1]
        rows -= row0
        strip_h = rows * ts
        cam = camera_at(cams, d).to(device)
        gt = gts[d, row0 * ts:row0 * ts + strip_h].to(device)
        background = _background(cfg, state.step, d, device)
        keep = ((row0 * ts + torch.arange(strip_h, device=device))
                < height)[:, None, None]

        optimizer.zero_grad(set_to_none=True)
        offset = torch.zeros((model.capacity, 2), dtype=torch.float32,
                             device=device, requires_grad=True)
        img, _, aux = render_strip(
            model, cam, raster_cfg, sh_degree, background, row0, rows,
            strip_pair_capacity(raster_cfg, model.capacity, ntile),
            mean2d_offset=offset,
            impl=resolve_shard_impl(impl if impl is not None else raster_cfg.impl,
                                    device))
        # Rows past the true height (tile padding) are zero on both sides.
        img = torch.where(keep, img, torch.zeros_like(img))
        gt = torch.where(keep, gt, torch.zeros_like(gt))
        ext = halo_exchange(torch.stack([img, gt]), mesh)
        smap = ssim_map(ext[0], ext[1])[SSIM_HALO:-SSIM_HALO]
        s_sum = torch.where(keep, smap, torch.zeros_like(smap)).sum()
        l1_sum = (img - gt).abs().sum()
        # This rank's share of mean-over-views[(1 - l) L1 + l (1 - SSIM)]:
        # the sum over (data, tile) is the whole objective (the constant
        # l * 1 is spread over the strips of each view).
        local = (((1.0 - lam) * l1_sum - lam * s_sum) / denom
                 + lam / ntile) / ndata
        local.backward()

        with torch.no_grad():
            params = [p for g in optimizer.param_groups for p in g["params"]]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            summed = all_reduce(_flat(grads + [offset.grad, local.detach()]),
                                "sum", world)
            parts = _unflat(summed, grads + [offset.grad, local])
            for p, g in zip(params, parts):
                p.grad = g.clone()
            grad2d, loss = parts[-2], parts[-1]
            radii = all_reduce(aux["radii"], "max", world)
            mse = all_reduce(((img - gt) ** 2).sum(), "sum", tile_g) / denom
            psnr = all_reduce(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)),
                              "sum", data_g) / ndata
            overflow = all_reduce(aux["overflow"].to(torch.int64), "sum", world)
            max_chunks = all_reduce(aux["max_chunks_needed"], "max", world)

        set_position_lr(optimizer, cfg, state.extent, state.step)
        optimizer.step()
        state.densify.update(grad2d, radii)
        state.step += 1
        metrics = dict(loss=loss, psnr=psnr, overflow=overflow,
                       max_chunks=max_chunks, num_alive=model.num_alive)
        if return_grads:
            metrics["grads"] = {g["name"]: g["params"][0].grad.clone()
                                for g in optimizer.param_groups}
        return state, metrics

    return step
