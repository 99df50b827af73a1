"""The forward raster path around K1: kernel or plain version, then
background compositing and tile-to-image reassembly.

Counterpart of the forward half of the reference's `_make_rasterizer`
(ops/pallas/rasterize.py). The backward kernel lands with the training
slice, so K1 is not differentiable: on CUDA tensors that require grad this
raises rather than silently routing autograd through the plain version. The
plain version stays differentiable by autograd (the CPU path).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import RasterConfig
from ..tile_raster import (
    RasterOut,
    max_chunks_needed,
    rasterize_forward_torch,
    tiles_to_image,
)
from .common import OUT_LOGT
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


def rasterize_tiles(
    sorted_payload: torch.Tensor,   # (P, 16) in (tile, depth) order
    tile_starts: torch.Tensor,      # (T + 1,) int32
    background: torch.Tensor,       # (3,)
    width: int,
    height: int,
    cfg: RasterConfig,
    impl: str,                      # 'cuda' (K1) or 'torch' (plain version)
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
) -> RasterOut:
    """Render sorted pairs. With `tile_rows` set, renders an uncropped
    (tile_rows * tile_size, W) strip whose first tile row is `tile_row0`."""
    ts = cfg.tile_size
    img_h = tile_rows * ts if tile_rows is not None else height
    if impl == "cuda":
        if torch.is_grad_enabled() and (sorted_payload.requires_grad
                                        or background.requires_grad):
            raise NotImplementedError(
                "the backward raster kernel lands with the training slice: "
                "render CUDA tensors under torch.no_grad(), or pass "
                "impl='torch' for the differentiable plain version")
        fwd = rasterize_forward_cuda
    elif impl == "torch":
        fwd = rasterize_forward_torch
    else:
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    out_tiles = fwd(sorted_payload, tile_starts, width, height, cfg,
                    tile_row0=tile_row0, tile_rows=tile_rows)
    image, trans = _compose_outputs(out_tiles, background, width, img_h, ts)
    return RasterOut(image=image, transmittance=trans,
                     max_chunks_needed=max_chunks_needed(tile_starts,
                                                         cfg.chunk_size))
