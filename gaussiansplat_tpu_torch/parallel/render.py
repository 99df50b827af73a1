"""Tile-sharded rendering: one view split into horizontal tile strips across
the mesh's tile axis.

Each rank projects every gaussian (cheap, O(N) elementwise), bins only the
tile rows of its strip into a per-strip pair capacity (K4), gathers the
payload and rasterizes its strip (K1; backward K2, then the gather's K3),
and the strips are gathered into the full frame on every rank of the tile
group. The per-gaussian parameter gradients of one strip are partial sums:
the caller sums them over the tile group (parallel/train.py does).

The strips are `strip_bounds`: where the tile rows do not divide evenly
across the axis, the first strips are one tile row longer than the rest.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import RasterConfig
from ..models.gaussians import GaussianModel
from ..ops.binning import bin_gaussians, resolve_impl, tile_grid
from ..ops.camera import Camera
from ..ops.projection import make_payload, project_gaussians
from ..ops.raster_dispatch import rasterize_payload
from ..utils.logging import span
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
    """All strips of the tile group, concatenated along rows: strip i is
    rows [bounds[i], bounds[i + 1]) of the result (`bounds`, group size + 1
    row offsets). Each strip is padded to the longest for the `all_gather`
    and cropped after it. Backward: this rank's rows of the frame's
    cotangent, for a loss that every rank of the tile group computes alike
    on the whole frame (the parameter gradients are then per-strip partial
    sums, summed over the group). The span `gs.strips` covers both
    directions."""

    @staticmethod
    def forward(ctx, strip, group, index, bounds):
        with span("gs.strips"):
            ctx.r0, ctx.r1 = bounds[index], bounds[index + 1]
            longest = max(b - a for a, b in zip(bounds[:-1], bounds[1:]))
            pad = torch.nn.functional.pad(
                strip, (0, 0) * (strip.dim() - 1) + (0, longest - strip.shape[0]))
            parts = all_gather(pad, group)
            return torch.cat([p[:b - a] for p, a, b in
                              zip(parts, bounds[:-1], bounds[1:])], dim=0)

    @staticmethod
    def backward(ctx, g):
        with span("gs.strips"):
            return g[ctx.r0:ctx.r1], None, None, None


def strip_bounds(tiles_y: int, n: int) -> List[int]:
    """Tile-row bounds of `n` horizontal strips of `tiles_y` tile rows:
    strip i is rows [b[i], b[i + 1]); the first `tiles_y % n` strips are
    one row longer than the rest."""
    base, extra = divmod(tiles_y, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


def check_strips(cfg: RasterConfig, height: int, ntile: int,
                 axis: str = TILE_AXIS) -> List[int]:
    """The tile-row bounds of the `axis` mesh axis' strips of a frame of
    `height` pixels (`strip_bounds`); raises when there are fewer tile rows
    than strips."""
    _, tiles_y = tile_grid(1, height, cfg.tile_size)
    if tiles_y < ntile:
        raise ValueError(
            f"{tiles_y} tile rows cannot make a strip for each of the "
            f"{ntile} ranks of the {axis} axis")
    return strip_bounds(tiles_y, ntile)


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
    bounds = check_strips(cfg, height, ntile)
    px = [b * cfg.tile_size for b in bounds]
    group = mesh.group(TILE_AXIS)

    def f(model: GaussianModel, camera: Camera, background: torch.Tensor):
        if camera.device != model.device:
            camera = camera.to(model.device)
        i = mesh.tile_index
        img, trans, _ = render_strip(
            model, camera, cfg, sh_degree, background, bounds[i],
            bounds[i + 1] - bounds[i],
            strip_pair_capacity(cfg, model.capacity, ntile),
            impl=resolve_shard_impl(impl if impl is not None else cfg.impl,
                                    model.device),
        )
        img = _GatherStrips.apply(img, group, i, px)
        trans = _GatherStrips.apply(trans, group, i, px)
        return img[:height], trans[:height]

    return f
