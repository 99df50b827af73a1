"""The raster path around K1 and K2: forward kernel (or its plain version),
background compositing and tile-to-image reassembly, and the backward as a
`torch.autograd.Function`.

Counterpart of the reference's `_make_rasterizer` (ops/pallas/rasterize.py,
unpacked form). The Function's forward launches K1 and keeps its output
block; its backward turns the image and transmittance cotangents into the
per-tile cotangent block, reads K1's stop row and launches K2, then zeroes
the rows past tile_starts[-1]. With impl='torch' the same Function runs the
plain versions of both kernels, so autograd never differentiates through
the plain forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import RasterConfig
from ...utils.logging import span
from ..tile_raster import (
    RasterOut,
    image_to_tiles,
    max_chunks_needed,
    rasterize_backward_torch,
    rasterize_forward_torch,
    tiles_to_image,
)
from .backward import rasterize_backward_cuda
from .common import NOUT, OUT_LOGT
from .forward import rasterize_forward_cuda


def _compose_outputs(out_tiles, background, width, height, ts):
    """Background compositing and tile grid -> image reassembly of the
    (T, NOUT, PX) block."""
    trans_tiles = torch.exp(out_tiles[:, OUT_LOGT, :])
    rgb_tiles = out_tiles[:, 0:3, :].transpose(1, 2)
    img_tiles = rgb_tiles + trans_tiles[..., None] * background[None, None, :]
    image = tiles_to_image(img_tiles, width, height, ts)
    trans = tiles_to_image(trans_tiles, width, height, ts)
    return image, trans


def _image_cotangents(dimg, dtrans, out_tiles, background, ts):
    """Image / transmittance cotangents -> the (T, NOUT, PX) cotangent block
    of K2 (rows dR, dG, dB, dlogT; rows 4 and 5, the weight-sum and depth
    outputs, stay zero: the rasterizer exposes neither) and the background's
    gradient."""
    dimg_tiles = image_to_tiles(dimg, ts)          # (T, PX, 3)
    dtrans_tiles = image_to_tiles(dtrans, ts)      # (T, PX)
    trans_tiles = torch.exp(out_tiles[:, OUT_LOGT, :])
    # d/d logT of the transmittance output and the background compositing.
    dtrans_total = dtrans_tiles + (dimg_tiles * background).sum(-1)
    dlog_t = dtrans_total * trans_tiles
    num_tiles, px = trans_tiles.shape
    cot_tiles = torch.cat([
        dimg_tiles.transpose(1, 2),
        dlog_t[:, None, :],
        torch.zeros((num_tiles, NOUT - 4, px), dtype=torch.float32,
                    device=trans_tiles.device),
    ], dim=1).contiguous()
    dbg = (dimg_tiles * trans_tiles[..., None]).sum((0, 1))
    return cot_tiles, dbg


class _Rasterize(torch.autograd.Function):
    """(sorted_payload, background) -> (image, transmittance); the backward
    launches K2 (or its plain version). Without grad (serving) the backward
    node is never kept, so nothing is held past the call."""

    @staticmethod
    def forward(ctx, sorted_payload, tile_starts, background, width, height,
                cfg, impl, tile_row0, tile_rows):
        fwd = rasterize_forward_cuda if impl == "cuda" else rasterize_forward_torch
        out_tiles = fwd(sorted_payload, tile_starts, width, height, cfg,
                        tile_row0=tile_row0, tile_rows=tile_rows)
        ts = cfg.tile_size
        img_h = tile_rows * ts if tile_rows is not None else height
        image, trans = _compose_outputs(out_tiles, background, width, img_h, ts)
        ctx.save_for_backward(sorted_payload, tile_starts, background, out_tiles)
        ctx.args = (width, height, cfg, impl, tile_row0, tile_rows)
        return image, trans

    @staticmethod
    def backward(ctx, dimg, dtrans):
        with span("gs.raster.bwd"):
            sorted_payload, tile_starts, background, out_tiles = ctx.saved_tensors
            width, height, cfg, impl, tile_row0, tile_rows = ctx.args
            cot_tiles, dbg = _image_cotangents(dimg, dtrans, out_tiles,
                                               background, cfg.tile_size)
            bwd = (rasterize_backward_cuda if impl == "cuda"
                   else rasterize_backward_torch)
            dsorted = bwd(sorted_payload, tile_starts, cot_tiles, out_tiles,
                          width, height, cfg, tile_row0=tile_row0,
                          tile_rows=tile_rows)
            # Rows past the last tile's segment belong to no tile: K2 leaves
            # them unwritten.
            p = sorted_payload.shape[0]
            valid = torch.arange(p, dtype=torch.int32,
                                 device=dsorted.device) < tile_starts[-1]
            dsorted.masked_fill_(~valid[:, None], 0.0)
        return dsorted, None, dbg, None, None, None, None, None, None


def rasterize_tiles(
    sorted_payload: torch.Tensor,   # (P, 16) in (tile, depth) order
    tile_starts: torch.Tensor,      # (T + 1,) int32
    background: torch.Tensor,       # (3,)
    width: int,
    height: int,
    cfg: RasterConfig,
    impl: str,                      # 'cuda' (K1, K2) or 'torch' (plain versions)
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
) -> RasterOut:
    """Render sorted pairs; differentiable w.r.t. `sorted_payload` and
    `background`. With `tile_rows` set, renders an uncropped
    (tile_rows * tile_size, W) strip whose first tile row is `tile_row0`."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    image, trans = _Rasterize.apply(sorted_payload, tile_starts, background,
                                    width, height, cfg, impl, tile_row0,
                                    tile_rows)
    return RasterOut(image=image, transmittance=trans,
                     max_chunks_needed=max_chunks_needed(tile_starts,
                                                         cfg.chunk_size))
