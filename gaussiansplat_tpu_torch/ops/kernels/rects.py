"""R, the binning's rects, survivor masks and pair counts: CUDA kernel
(csrc/rects.cu) and a plain per-gaussian twin of its loop.

For each gaussian the kernel writes its packed tile rect, its survivor mask,
its clamped pair count and the compaction sort's depth key, as
`ops/binning.tile_rects_torch` (the plain version, eager PyTorch over (N,
32) lanes) computes them, bit for bit. The rects are int32, or int64 on tile
grids whose four rect fields need more than 31 bits (`gs_tile_rects`,
`gs_tile_rects_i64`); no survivor mask is made on those, as in the plain
version.

`tile_rects_twin` walks one gaussian at a time over only the tiles of its
own rect, with numpy float32 scalars in the kernel's order of operations:
the CPU tests hold it to the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from .build import CudaKernel

I32 = torch.int32
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# csrc/rects.cu's launch shape: one thread a gaussian.
THREADS = 256
# Rects of at most this many tiles get an exact per-tile support test (a
# 32-bit survivor mask, row-major over the rect); larger rects keep every
# tile.
MASK_TILES = 32

RECTS = CudaKernel(
    "rects.cu", "gs_tile_rects",
    # mean2d, s_mean, conic, s_conic, opacity, s_op, depth, s_depth,
    # radius_xy, s_rad, valid, s_valid, n, tile_size, tiles_x, tiles_y,
    # tile_row0, tile_rows, by, bw, bh, cull, max_tiles, inv_tile, tau_max,
    # log_alpha_min, rect, mask, count, key, stream
    [_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
     _P, _P, _P, _P, _P],
)

# The launcher of each rect width.
RECT_SYMBOLS = {torch.int32: "gs_tile_rects", torch.int64: "gs_tile_rects_i64"}

__all__ = ["RECTS", "RECT_SYMBOLS", "tile_rects_cuda", "tile_rects_twin"]


def _launch_args(t: torch.Tensor):
    return t.data_ptr(), t.stride(0)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    # Rows may be strided (a column of the payload); a row's own entries
    # must be adjacent.
    if t.ndim == 2 and t.stride(1) != 1 and t.shape[1] > 1:
        raise ValueError(f"{name} must be contiguous within a row")


def tile_rects_cuda(mean2d, conic, opacity, depth, radius_xy, valid, cfg,
                    tiles_x: int, tiles_y: int, tile_row0: int,
                    tile_rows: int, pack_bits, rect_dtype
                    ) -> Tuple[torch.Tensor, ...]:
    """Launch R on the current stream: (rect, mask, count, depth_key), each
    (N,), rect of `rect_dtype` (int32, or int64 on tile grids too large to
    pack in 31 bits), mask and count int32, depth_key float32. Fields as in
    `Projected` (float32 mean2d (N, 2), conic (N, 3), opacity, depth; int32
    radius_xy (N, 2); bool valid), on one CUDA device; rows may be strided."""
    n = mean2d.shape[0] if mean2d.ndim else 0
    _check("mean2d", mean2d, torch.float32, (n, 2))
    _check("conic", conic, torch.float32, (n, 3))
    _check("opacity", opacity, torch.float32, (n,))
    _check("depth", depth, torch.float32, (n,))
    _check("radius_xy", radius_xy, I32, (n, 2))
    _check("valid", valid, torch.bool, (n,))
    if rect_dtype not in RECT_SYMBOLS:
        raise ValueError(f"rects are int32 or int64, not {rect_dtype}")
    devices = {t.device for t in (mean2d, conic, opacity, depth, radius_xy,
                                  valid)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tile_rects_cuda needs CUDA tensors on one device, "
                         f"got {sorted(map(str, devices))}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"R takes 1 <= N < 2^31 gaussians (N={n})")
    dev = mean2d.device
    rect = torch.empty((n,), dtype=rect_dtype, device=dev)
    mask = torch.empty((n,), dtype=I32, device=dev)
    count = torch.empty((n,), dtype=I32, device=dev)
    key = torch.empty((n,), dtype=torch.float32, device=dev)
    by, bw, bh = pack_bits
    # What torch's CUDA division of a float32 tensor by a Python number
    # multiplies with: the float32 reciprocal.
    inv_tile = float(np.float32(1.0) / np.float32(cfg.tile_size))
    stream = torch.cuda.current_stream(dev).cuda_stream
    RECTS.launch(
        *_launch_args(mean2d), *_launch_args(conic), *_launch_args(opacity),
        *_launch_args(depth), *_launch_args(radius_xy), *_launch_args(valid),
        n, cfg.tile_size, tiles_x, tiles_y, tile_row0, tile_rows, by, bw, bh,
        int(cfg.tile_cull), cfg.max_tiles_per_gaussian, inv_tile,
        cfg.sigma_radius * cfg.sigma_radius, math.log(cfg.alpha_min),
        rect.data_ptr(), mask.data_ptr(), count.data_ptr(), key.data_ptr(),
        stream, symbol=RECT_SYMBOLS[rect_dtype],
    )
    return rect, mask, count, key


def _nan_max(a, b):
    return a if (a > b or a != a) else b


def _nan_min(a, b):
    return a if (a < b or a != a) else b


def _quad(a, b2, c, x, y):
    return a * x * x + b2 * x * y + c * y * y


def tile_rects_twin(mean2d, conic, opacity, depth, radius_xy, valid, cfg,
                    tiles_x: int, tiles_y: int, tile_row0: int,
                    tile_rows: int, pack_bits, rect_dtype):
    """Plain twin of csrc/rects.cu, one gaussian at a time: the same
    (rect, mask, count, depth_key) from CPU tensors, each float expression
    in the kernel's order with numpy float32 scalars, the survivor test over
    only the rect's own tiles. The support bound tau = min(2 ln(op /
    alpha_min), sigma_radius^2) comes from torch's own ops over N, as in
    the plain version (numpy's log may round apart from torch's).
    Slow (a Python loop): for small test scenes."""
    f32 = np.float32
    tau = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))
                 - float(math.log(cfg.alpha_min)))
    tau = torch.clamp(tau, max=cfg.sigma_radius * cfg.sigma_radius)
    m = mean2d.numpy().astype(f32)
    cn = conic.numpy().astype(f32)
    ta = tau.numpy().astype(f32)
    dp = depth.numpy().astype(f32)
    rr = radius_xy.numpy()
    ok = valid.numpy()
    n = m.shape[0]
    by, bw, bh = pack_bits
    ts = f32(cfg.tile_size)
    inv = f32(1.0) / ts
    cull = cfg.tile_cull and rect_dtype == torch.int32
    mt = cfg.max_tiles_per_gaussian
    rect = np.zeros(n, np.int64)
    mask = np.zeros(n, np.uint32)
    count = np.zeros(n, np.int32)
    key = np.full(n, np.inf, f32)

    def to_tile(x, hi):
        return int(_nan_min(_nan_max(np.floor(x), f32(0)), f32(hi)))

    with np.errstate(all="ignore"):
        for i in range(n):
            if not ok[i]:
                continue
            u, v = m[i, 0], m[i, 1]
            rx, ry = f32(rr[i, 0]), f32(rr[i, 1])
            xmin = to_tile((u - rx) * inv, tiles_x)
            ymin = to_tile((v - ry) * inv, tiles_y)
            xmax = to_tile(np.floor((u + rx) * inv) + f32(1), tiles_x)
            ymax = to_tile(np.floor((v + ry) * inv) + f32(1), tiles_y)
            empty = rr[i, 0] <= 0 or rr[i, 1] <= 0
            xmax = xmin if empty else max(xmax, xmin)
            ymax = ymin if empty else max(ymax, ymin)
            ymin = min(max(ymin - tile_row0, 0), tile_rows)
            ymax = min(max(ymax - tile_row0, 0), tile_rows)
            tw, th = xmax - xmin, ymax - ymin
            area = tw * th
            c = min(area, mt)
            bits = 0
            if cull and c > 0 and area <= MASK_TILES:
                ca, cb, cc = cn[i]
                ca_s = _nan_max(ca, f32(1e-12))
                cc_s = _nan_max(cc, f32(1e-12))
                cb2 = f32(2) * cb
                for ky in range(th):
                    y0 = f32((ymin + ky + tile_row0) * cfg.tile_size) - v
                    y1 = y0 + ts
                    ye = _nan_min(_nan_max(f32(0), y0), y1)
                    for kx in range(tw):
                        x0 = f32((xmin + kx) * cfg.tile_size) - u
                        x1 = x0 + ts
                        xe = _nan_min(_nan_max(f32(0), x0), x1)
                        ys = _nan_min(_nan_max(-cb * xe / cc_s, y0), y1)
                        xs = _nan_min(_nan_max(-cb * ye / ca_s, x0), x1)
                        q = _nan_min(_quad(ca, cb2, cc, xe, ys),
                                     _quad(ca, cb2, cc, xs, ye))
                        if q * f32(0.999) - f32(1e-2) <= ta[i]:
                            bits |= 1 << (ky * tw + kx)
                c = min(bin(bits).count("1"), mt)
            mask[i] = bits
            count[i] = c
            if c > 0:
                rect[i] = ((((((xmin << by) | ymin) << bw) | tw) << bh) | th)
                key[i] = dp[i]
    rect_t = torch.from_numpy(rect)
    if rect_dtype == torch.int32:
        rect_t = rect_t.to(I32)
    return (rect_t, torch.from_numpy(mask.view(np.int32).copy()),
            torch.from_numpy(count), torch.from_numpy(key))
