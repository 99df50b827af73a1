"""The back half of every render path: bin projected gaussians, gather the
payload into sorted pair order and rasterize it, on the hand-written CUDA
kernels or their plain PyTorch versions.

The backend is `RasterConfig.impl`: 'auto' (CUDA tensors use the kernels,
CPU tensors the plain versions), 'cuda' (CUDA tensors only; raises on CPU
tensors) or 'torch' (the plain versions on any device, for tests and for
comparing the kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .binning import TileBinning, bin_gaussians, resolve_impl
from .kernels.rasterize import rasterize_tiles
from .projection import Projected, make_payload, payload_to_projected
from .tile_raster import RasterOut
from ..utils.logging import count, span


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor              # (H, W, 3)
    transmittance: torch.Tensor      # (H, W)
    radii: torch.Tensor              # (N,) int32 screen-space radius (0 = culled)
    num_pairs: torch.Tensor          # () int32 tile/gaussian pairs binned
    overflow: torch.Tensor           # () int32 pairs dropped (capacity exceeded)
    max_chunks_needed: torch.Tensor  # () int32 longest tile list, in chunks

    @classmethod
    def of(cls, out: RasterOut, binning: TileBinning,
           radii: torch.Tensor) -> "RenderOutput":
        return cls(image=out.image, transmittance=out.transmittance,
                   radii=radii, num_pairs=binning.num_pairs,
                   overflow=binning.overflow,
                   max_chunks_needed=out.max_chunks_needed)


def rasterize_projected(
    proj: Optional[Projected],
    width: int,
    height: int,
    cfg,
    background: torch.Tensor,      # (3,)
    payload: Optional[torch.Tensor] = None,   # (M, PAYLOAD_DIM) rows of proj
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    capacity: Optional[int] = None,
) -> Tuple[RasterOut, TileBinning]:
    """Bin `proj` into the frame's tile grid (or the strip of `tile_rows`
    tile rows from `tile_row0`, into `capacity` pair slots), gather its
    payload into sorted pair order and rasterize it. Differentiable w.r.t.
    the payload and `background` (backward: K2, then the gather's K3
    reduce, or their plain versions).

    Without `payload` it is made from `proj` after the binning, so that it
    is not held through the binning's peak of memory. With `proj` None it
    is decoded from `payload` (the arrivals of an exchange). Spans
    (utils/logging.py): `gs.bin` (counters `pairs` and `pair_slots`, the
    pairs binned and the pair sort's slots), `gs.project` for a payload
    made here, `gs.gather` and `gs.raster`."""
    device = (payload if proj is None else proj.mean2d).device
    impl = resolve_impl(cfg.impl, device)
    with span("gs.bin"):
        if proj is None:
            proj = payload_to_projected(payload)
        binning = bin_gaussians(proj, width, height, cfg, tile_row0=tile_row0,
                                tile_rows=tile_rows, capacity=capacity,
                                impl=impl)
        count("pairs", binning.num_pairs)
        count("pair_slots", binning.sorted_ranks.shape[0])
    if payload is None:
        with span("gs.project"):
            payload = make_payload(proj)
    with span("gs.gather"):
        sorted_payload = binning.gather_payload(payload, impl)
    with span("gs.raster"):
        out = rasterize_tiles(
            sorted_payload, binning.tile_starts, background, width, height,
            cfg, impl, tile_row0=tile_row0, tile_rows=tile_rows,
        )
    return out, binning
