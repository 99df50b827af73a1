"""K1, the forward tile rasterizer: CUDA kernel (csrc/forward.cu) and its
plain version (ops/tile_raster.rasterize_forward_torch).

Input: the (P, 16) f32 payload rows in sorted (tile, depth) order and the
(T + 1,) int32 tile segment offsets. Output: the (T, 8, tile_size^2) f32
block with rows R, G, B, logT, weight sum, depth sum, chunks composited, 0
(the layout of the TPU kernel, ops/pallas/forward.py in the reference).
`ablate=` selects a timing variant (ops/kernels/ablate.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import RasterConfig
from ..binning import tile_grid
from ..projection import PAYLOAD_DIM
from ..tile_raster import log_trans_eps, rasterize_forward_torch
from . import ablate as _ablate
from .build import CudaKernel
from .common import LANE_BYTES, NOUT

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FORWARD = CudaKernel(
    "forward.cu", "gs_rasterize_forward",
    # payload, tile_starts, num_tiles, tile_size, chunk_size, tiles_x,
    # tile_row0, alpha_min, alpha_max, sigma_sq, log_eps, out, stream
    [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
)

__all__ = ["FORWARD", "rasterize_forward_cuda", "rasterize_forward_torch"]


# Shared memory a block may opt into on sm_90 (232,448 bytes).
MAX_SMEM = 227 * 1024


def _check_tile_size(tile_size: int) -> None:
    """One block renders a tile, one thread per 2x2 pixel quad, in warps of
    16x8 pixels: the layout of csrc/raster_common.cuh covers tiles up to 32."""
    if not 1 <= tile_size <= 32:
        raise ValueError(
            f"the raster kernels require 1 <= tile_size <= 32 (got "
            f"{tile_size}): one block of at most 8 warps per tile")


def _check_payload(sorted_payload: torch.Tensor) -> None:
    """The kernels stage each row with 16-byte loads."""
    if not sorted_payload.is_contiguous() or sorted_payload.data_ptr() % 16:
        raise ValueError("payload must be contiguous and 16-byte aligned")


def rasterize_forward_cuda(
    sorted_payload: torch.Tensor,   # (P, 16) f32, CUDA, contiguous
    tile_starts: torch.Tensor,      # (T + 1,) int32, CUDA
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    ablate: str = "",
) -> torch.Tensor:
    """Launch K1 on the current stream; returns the (T, 8, tile_px) block.
    `ablate` names a timing variant (ops/kernels/ablate.py), launched from
    its own build and counted on its own kernel; '' is production."""
    _ablate.check("forward", ablate)
    _check_tile_size(cfg.tile_size)
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
    num_tiles = tiles_x * (tiles_y if tile_rows is None else tile_rows)
    if sorted_payload.device.type != "cuda" or tile_starts.device.type != "cuda":
        raise ValueError("rasterize_forward_cuda needs CUDA tensors")
    if sorted_payload.dtype != torch.float32 or sorted_payload.ndim != 2 \
            or sorted_payload.shape[1] != PAYLOAD_DIM:
        raise ValueError(f"payload must be (P, {PAYLOAD_DIM}) float32, got "
                         f"{tuple(sorted_payload.shape)} {sorted_payload.dtype}")
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (num_tiles + 1,):
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got "
                         f"{tuple(tile_starts.shape)} {tile_starts.dtype}")
    if not tile_starts.is_contiguous():
        raise ValueError("tile_starts must be contiguous")
    _check_payload(sorted_payload)
    if cfg.chunk_size * LANE_BYTES > MAX_SMEM:
        raise ValueError(f"chunk_size {cfg.chunk_size} needs more than "
                         f"{MAX_SMEM} B of shared memory per block")
    px = cfg.tile_size * cfg.tile_size
    out = torch.empty((num_tiles, NOUT, px), dtype=torch.float32,
                      device=sorted_payload.device)
    if num_tiles == 0:
        return out
    stream = torch.cuda.current_stream(sorted_payload.device).cuda_stream
    kernel = (_ablate.variant_kernel("forward", FORWARD, ablate) if ablate
              else FORWARD)
    kernel.launch(
        sorted_payload.data_ptr(), tile_starts.data_ptr(), num_tiles,
        cfg.tile_size, cfg.chunk_size, tiles_x, int(tile_row0),
        cfg.alpha_min, cfg.alpha_max, cfg.sigma_radius * cfg.sigma_radius,
        log_trans_eps(cfg), out.data_ptr(), stream,
    )
    return out
