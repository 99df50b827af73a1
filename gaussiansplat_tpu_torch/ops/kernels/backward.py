"""K2, the backward tile rasterizer: CUDA kernel (csrc/backward.cu) and its
plain version (ops/tile_raster.rasterize_backward_torch).

Inputs: the (P, 16) f32 payload rows in sorted (tile, depth) order, the
(T + 1,) int32 tile segment offsets, the (T, 8, tile_size^2) cotangent block
(rows dR, dG, dB, dlogT, dWsum, dDepth, 0, 0) and K1's forward block of the
same shape (row 3 the final logT, row 6 the chunks composited). Output: the
(P, 16) f32 per-pair gradient rows. The kernel leaves rows past
tile_starts[-1] unwritten; the caller masks them (ops/kernels/rasterize.py).
`ablate=` selects a timing variant (ops/kernels/ablate.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import RasterConfig
from ..binning import tile_grid
from ..projection import PAYLOAD_DIM
from ..tile_raster import rasterize_backward_torch
from . import ablate as _ablate
from .build import CudaKernel
from .common import LANE_BYTES, NOUT, raster_warps
from .forward import MAX_SMEM, _check_payload, _check_tile_size

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

BACKWARD = CudaKernel(
    "backward.cu", "gs_rasterize_backward",
    # payload, tile_starts, fwd, cot, num_tiles, tile_size, chunk_size,
    # tiles_x, tile_row0, alpha_min, alpha_max, sigma_sq, dpayload, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P],
)

# Pairs whose per-warp partial rows K2 keeps in shared memory at once
# (kSub in csrc/backward.cu), 11 summed channels each.
_SUB_PAIRS, _SUB_CHANNELS = 128, 11

__all__ = ["BACKWARD", "rasterize_backward_cuda", "rasterize_backward_torch"]


def rasterize_backward_cuda(
    sorted_payload: torch.Tensor,   # (P, 16) f32, CUDA, contiguous
    tile_starts: torch.Tensor,      # (T + 1,) int32, CUDA
    cot_tiles: torch.Tensor,        # (T, 8, tile_px) f32, CUDA
    fwd_tiles: torch.Tensor,        # (T, 8, tile_px) f32, CUDA
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    ablate: str = "",
) -> torch.Tensor:
    """Launch K2 on the current stream; returns the (P, 16) gradient rows
    (rows >= tile_starts[-1] uninitialised). `ablate` names a timing variant
    (ops/kernels/ablate.py), launched from its own build and counted on its
    own kernel; '' is production."""
    _ablate.check("backward", ablate)
    _check_tile_size(cfg.tile_size)
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
    num_tiles = tiles_x * (tiles_y if tile_rows is None else tile_rows)
    px = cfg.tile_size * cfg.tile_size
    tensors = dict(sorted_payload=sorted_payload, tile_starts=tile_starts,
                   cot_tiles=cot_tiles, fwd_tiles=fwd_tiles)
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"rasterize_backward_cuda needs CUDA tensors "
                             f"({name} is on {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sorted_payload.dtype != torch.float32 or sorted_payload.ndim != 2 \
            or sorted_payload.shape[1] != PAYLOAD_DIM:
        raise ValueError(f"payload must be (P, {PAYLOAD_DIM}) float32, got "
                         f"{tuple(sorted_payload.shape)} {sorted_payload.dtype}")
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (num_tiles + 1,):
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got "
                         f"{tuple(tile_starts.shape)} {tile_starts.dtype}")
    for name in ("cot_tiles", "fwd_tiles"):
        t = tensors[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (num_tiles, NOUT, px):
            raise ValueError(f"{name} must be ({num_tiles}, {NOUT}, {px}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    _check_payload(sorted_payload)
    wx, wy = raster_warps(cfg.tile_size)
    smem = cfg.chunk_size * LANE_BYTES + wx * wy * _SUB_PAIRS * _SUB_CHANNELS * 4
    if smem > MAX_SMEM:
        raise ValueError(f"chunk_size {cfg.chunk_size} needs {smem} B of "
                         f"shared memory per block, above {MAX_SMEM}")
    out = torch.empty_like(sorted_payload)
    if num_tiles == 0:
        return out
    stream = torch.cuda.current_stream(sorted_payload.device).cuda_stream
    kernel = (_ablate.variant_kernel("backward", BACKWARD, ablate) if ablate
              else BACKWARD)
    kernel.launch(
        sorted_payload.data_ptr(), tile_starts.data_ptr(), fwd_tiles.data_ptr(),
        cot_tiles.data_ptr(), num_tiles, cfg.tile_size, cfg.chunk_size,
        tiles_x, int(tile_row0), cfg.alpha_min, cfg.alpha_max,
        cfg.sigma_radius * cfg.sigma_radius, out.data_ptr(), stream,
    )
    return out
