"""Tile-sharded rendering: one view split into horizontal tile strips across
the mesh's tile axis.

Each rank projects every gaussian (cheap, O(N) elementwise), bins only the
tile rows of its strip into a per-strip pair capacity (K4), gathers the
payload and rasterizes its strip (K1; backward K2, then the gather's K3),
and the strips are gathered into the full frame on every rank of the tile
group. The per-gaussian parameter gradients of one strip are partial sums:
the caller sums them over the tile group (parallel/train.py does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import RasterConfig
from ..models.gaussians import GaussianModel
from ..ops.binning import bin_gaussians, resolve_impl, tile_grid
from ..ops.camera import Camera
from ..ops.projection import make_payload, project_gaussians
from ..ops.raster_dispatch import rasterize_payload
from .mesh import TILE_AXIS, Mesh, all_gather


def resolve_shard_impl(impl: Optional[str], device: torch.device) -> str:
    """The raster backend of the sharded renderers: 'auto' -> the kernels
    for CUDA tensors, the plain versions for CPU tensors (`resolve_impl`)."""
    return resolve_impl(impl if impl is not None else "auto", device)


def strip_pair_capacity(cfg: RasterConfig, n: int, ntile: int) -> int:
    """The pair capacity of one of `ntile` strips of an n-gaussian frame."""
    return max(cfg.pair_capacity(n) // ntile, 4 * cfg.chunk_size)


def render_strip(
    model: GaussianModel,
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int,
    background: torch.Tensor,
    tile_row0: int,
    tile_rows: int,
    pair_capacity: int,
    mean2d_offset: Optional[torch.Tensor] = None,
    impl: str = "auto",
):
    """Render `tile_rows` tile rows starting at tile row `tile_row0`.
    Returns (strip image (tile_rows * ts, W, 3), strip transmittance, aux
    dict with radii, num_pairs, overflow, max_chunks_needed).
    Differentiable w.r.t. the model's parameters, `background` and
    `mean2d_offset`."""
    impl = resolve_impl(impl, model.device)
    proj = project_gaussians(
        model.means, model.quats, model.log_scales, model.logit_opacities,
        model.sh, camera, cfg, sh_degree=sh_degree, alive=model.alive,
    )
    if mean2d_offset is not None:
        proj = dataclasses.replace(proj, mean2d=proj.mean2d + mean2d_offset)
    binning = bin_gaussians(
        proj, camera.width, camera.height, cfg, tile_row0=tile_row0,
        tile_rows=tile_rows, capacity=pair_capacity, impl=impl,
    )
    out = rasterize_payload(
        make_payload(proj), binning, background, camera.width, camera.height,
        cfg, impl, tile_row0=tile_row0, tile_rows=tile_rows,
    )
    aux = dict(radii=proj.radius, num_pairs=binning.num_pairs,
               overflow=binning.overflow,
               max_chunks_needed=out.max_chunks_needed)
    return out.image, out.transmittance, aux


class _GatherStrips(torch.autograd.Function):
    """All strips of the tile group, concatenated along rows. Backward:
    this rank's rows of the frame's cotangent, for a loss that every rank
    of the tile group computes alike on the whole frame (the parameter
    gradients are then per-strip partial sums, summed over the group)."""

    @staticmethod
    def forward(ctx, strip, group, index):
        ctx.index, ctx.rows = index, strip.shape[0]
        return torch.cat(all_gather(strip, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.index * ctx.rows
        return g[r0:r0 + ctx.rows], None, None


def check_strips(cfg: RasterConfig, height: int, ntile: int,
                 axis: str = TILE_AXIS) -> int:
    """Tile rows per strip of the `axis` mesh axis; raises unless the tile
    rows divide evenly."""
    _, tiles_y = tile_grid(1, height, cfg.tile_size)
    if tiles_y % ntile != 0:
        raise ValueError(
            f"tile rows ({tiles_y}) must divide evenly across the {axis} axis "
            f"({ntile}); pad the image height to a multiple of "
            f"{cfg.tile_size * ntile} pixels")
    return tiles_y // ntile


def make_tile_sharded_render(
    mesh: Mesh,
    cfg: RasterConfig,
    width: int,
    height: int,
    sh_degree: int,
    impl: Optional[str] = None,
):
    """Build `f(model, camera, background) -> (image, transmittance)` that
    renders this rank's strip of the tile axis and gathers every strip of
    its tile group: the (height, width) frame on every rank, cropped from
    the tile-padded one. `impl` ('auto', 'cuda', 'torch') defaults to
    `cfg.impl`."""
    ntile = mesh.tile
    rows = check_strips(cfg, height, ntile)
    group = mesh.group(TILE_AXIS)

    def f(model: GaussianModel, camera: Camera, background: torch.Tensor):
        if camera.device != model.device:
            camera = camera.to(model.device)
        row0 = mesh.tile_index * rows
        img, trans, _ = render_strip(
            model, camera, cfg, sh_degree, background, row0, rows,
            strip_pair_capacity(cfg, model.capacity, ntile),
            impl=resolve_shard_impl(impl if impl is not None else cfg.impl,
                                    model.device),
        )
        img = _GatherStrips.apply(img, group, mesh.tile_index)
        trans = _GatherStrips.apply(trans, group, mesh.tile_index)
        return img[:height], trans[:height]

    return f
