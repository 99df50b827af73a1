"""Backend dispatch for the tile rasterizer: the hand-written CUDA kernels or
their plain PyTorch versions.

`impl`: 'auto' (CUDA tensors use the kernels, CPU tensors the plain
versions), 'cuda' (CUDA tensors only; raises on CPU tensors) or 'torch' (the
plain versions on any device, for tests and for comparing the kernels).
"""

from __future__ import annotations

from typing import Optional

import torch

from .binning import TileBinning, resolve_impl
from .kernels.rasterize import rasterize_tiles
from .tile_raster import RasterOut
from ..utils.logging import span


def rasterize_payload(
    payload: torch.Tensor,    # (M, PAYLOAD_DIM) per-gaussian rows
    binning: TileBinning,     # built over the same M rows
    background: torch.Tensor,  # (3,)
    width: int,
    height: int,
    cfg,
    impl: str = "auto",
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
) -> RasterOut:
    """Gather the payload into sorted pair order and rasterize it;
    differentiable w.r.t. `payload` and `background` (backward: K2, then the
    gather's K3 reduce, or their plain versions with impl='torch')."""
    impl = resolve_impl(impl, payload.device)
    with span("gs.gather"):
        sorted_payload = binning.gather_payload(payload, impl)
    with span("gs.raster"):
        return rasterize_tiles(
            sorted_payload, binning.tile_starts, background, width, height,
            cfg, impl, tile_row0=tile_row0, tile_rows=tile_rows,
        )
