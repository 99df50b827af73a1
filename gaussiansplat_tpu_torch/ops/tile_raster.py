"""Tile-grid image helpers and the plain PyTorch versions of the forward
and backward raster kernels (K1, ops/kernels/forward.py; K2,
ops/kernels/backward.py).

`rasterize_forward_torch` computes exactly what K1 computes, batched over
tiles: each tile walks its depth-sorted segment in chunk_size windows
aligned down to a multiple of chunk_size, gates alpha at alpha_min and
q <= sigma^2, composites front to back in log-transmittance (within a chunk
by a cumulative sum of log1p(-alpha)), and stops after the first chunk in
which every pixel's logT <= log(trans_eps).

`rasterize_backward_torch` repeats K2's arithmetic the same way: it replays
the chunks the forward composited (its stop row) in reverse, rewinds logT
from the saved final value by cumulative sums of log1p(-alpha), and sums
each pair's gradient row over the tile's pixels. Autograd never runs through
either: the rasterizer's `torch.autograd.Function` (ops/kernels/rasterize.py)
calls the backward explicitly.

Both take `ablate=`, the plain versions of the kernels' timing variants
(ops/kernels/ablate.py): the outputs the variant keeps, and zeros where the
variant leaves values under 1e-20.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import RasterConfig
from .binning import tile_grid
from .kernels import ablate as _ablate
from .kernels.common import NOUT, OUT_LOGT, OUT_STOP
from .projection import PAYLOAD_DIM


class RasterOut(NamedTuple):
    image: torch.Tensor              # (H, W, 3)
    transmittance: torch.Tensor      # (H, W) final T per pixel
    max_chunks_needed: torch.Tensor  # () int32 longest tile list, in chunks


def tiles_to_image(tiles: torch.Tensor, width: int, height: int,
                   tile_size: int) -> torch.Tensor:
    """(num_tiles, tile_px[, C]) -> (H, W[, C])."""
    squeeze = tiles.ndim == 2
    if squeeze:
        tiles = tiles[..., None]
    tx, ty = tile_grid(width, height, tile_size)
    c = tiles.shape[-1]
    img = tiles.reshape(ty, tx, tile_size, tile_size, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(ty * tile_size, tx * tile_size, c)
    img = img[:height, :width]
    return img[..., 0] if squeeze else img


def image_to_tiles(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(H, W[, C]) -> (num_tiles, tile_px[, C]), zero-padded to tile multiples."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    tx, ty = tile_grid(w, h, tile_size)
    img = torch.nn.functional.pad(
        img, (0, 0, 0, tx * tile_size - w, 0, ty * tile_size - h))
    t = img.reshape(ty, tile_size, tx, tile_size, c).permute(0, 2, 1, 3, 4)
    t = t.reshape(ty * tx, tile_size * tile_size, c)
    return t[..., 0] if squeeze else t


def log_trans_eps(cfg: RasterConfig) -> float:
    """The early-exit threshold on logT (-1e30, i.e. never, if trans_eps <= 0)."""
    return math.log(cfg.trans_eps) if cfg.trans_eps > 0 else -1e30


# Tiles composited together by the plain version: bounds its (tiles, px,
# chunk) intermediates to ~32M elements each.
_TILE_BATCH_ELEMS = 1 << 25


def alpha_gates(ca, cb, cc, op, dx, dy, cfg: RasterConfig):
    """q, alpha before the clamp, and whether the pair is live (alpha_raw >=
    alpha_min and q <= sigma^2) at pixel offsets (dx, dy): the gates of K1
    and K2 (csrc/raster_common.cuh), in the same factored order."""
    q = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
    alpha_raw = op * torch.exp(-0.5 * q)
    live = (alpha_raw >= cfg.alpha_min) & (q <= cfg.sigma_radius * cfg.sigma_radius)
    return q, alpha_raw, live


def support_extent(ca, cb, cc, op, cfg: RasterConfig):
    """(qcut, hx, hy) of each pair: the plain twin of `support_extent` in
    csrc/raster_common.cuh, in f32, used by the tests and chip_smoke.py.

    A (pixel, pair) that passes `alpha_gates` has q <= qcut and its rounded
    offsets within |dx| <= hx, |dy| <= hy; K1 and K2 skip the rest (see the
    CUDA source for the margins). hx = hy = inf where the conic is not
    positive definite or too ill-conditioned to bound the rounding of q."""
    sigma_sq = cfg.sigma_radius * cfg.sigma_radius
    r2 = torch.clamp(torch.fmin(torch.full_like(op, sigma_sq),
                                2.0 * torch.log(op / cfg.alpha_min)), min=0.0)
    qcut = (r2 + 1e-4 * r2.abs()) + 1e-4
    det = ca * cc - cb * cb
    s = ca + cc
    kappa = s * s / det
    cull = (ca > 0) & (det > 0) & (kappa <= 6.25e4)
    qbox = torch.clamp(qcut * (1.0001 + 4e-6 * kappa), min=0.0)
    inf = torch.full_like(op, math.inf)
    hx = torch.where(cull, torch.sqrt(qbox * cc / det), inf)
    hy = torch.where(cull, torch.sqrt(qbox * ca / det), inf)
    return qcut, hx, hy


def rasterize_forward_torch(
    sorted_payload: torch.Tensor,   # (P, 16) rows in (tile, depth) order
    tile_starts: torch.Tensor,      # (T + 1,) int32
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    ablate: str = "",
) -> torch.Tensor:
    """Plain version of K1. Returns the (T, NOUT, tile_px) block: rows R, G,
    B, logT, weight sum, depth sum, chunks composited (as f32), 0.

    `ablate`: 'noacc' keeps logT and the stop row, with R, G, B, weight sum
    and depth 0; 'dmaonly' never composites, so logT is 0 and the stop row
    counts every chunk of the tile's segment."""
    _ablate.check("forward", ablate)
    _ablate.no_plain_version("forward", ablate)
    ts, cs = cfg.tile_size, cfg.chunk_size
    px = ts * ts
    tiles_x, tiles_y = tile_grid(width, height, ts)
    num_tiles = tiles_x * (tiles_y if tile_rows is None else tile_rows)
    device = sorted_payload.device
    p = sorted_payload.shape[0]
    log_eps = log_trans_eps(cfg)
    if ablate == "dmaonly":
        start, end = tile_starts[:-1].to(torch.int64), tile_starts[1:].to(torch.int64)
        base = torch.div(start, cs, rounding_mode="floor") * cs
        n_chunks = torch.div(end - base + cs - 1, cs, rounding_mode="floor")
        out = torch.zeros((num_tiles, NOUT, px), dtype=torch.float32,
                          device=device)
        out[:, OUT_STOP] = n_chunks.to(torch.float32)[:, None]
        return out

    idx = torch.arange(px, device=device)
    xl = (idx % ts).to(torch.float32)[None, :, None]
    yl = (idx // ts).to(torch.float32)[None, :, None]
    lane = torch.arange(cs, device=device, dtype=torch.int64)

    starts_all = tile_starts[:-1].to(torch.int64)
    ends_all = tile_starts[1:].to(torch.int64)
    batch = max(1, _TILE_BATCH_ELEMS // (px * cs))
    blocks = []
    for t0 in range(0, num_tiles, batch):
        t = torch.arange(t0, min(t0 + batch, num_tiles), device=device)
        start, end = starts_all[t], ends_all[t]
        base = torch.div(start, cs, rounding_mode="floor") * cs
        n_chunks = torch.div(end - base + cs - 1, cs, rounding_mode="floor")
        ox = ((t % tiles_x) * ts).to(torch.float32)[:, None]
        oy = ((t // tiles_x + tile_row0) * ts).to(torch.float32)[:, None]
        nb = t.shape[0]
        acc = torch.zeros((nb, px, 5), dtype=torch.float32, device=device)
        log_t = torch.zeros((nb, px), dtype=torch.float32, device=device)
        alive = torch.ones((nb,), dtype=torch.bool, device=device)
        stop = torch.zeros((nb,), dtype=torch.int64, device=device)
        for ci in range(int(n_chunks.max().item()) if nb else 0):
            active = alive & (ci < n_chunks)
            if not bool(active.any()):
                break
            gidx = base[:, None] + ci * cs + lane[None, :]          # (B, CS)
            in_seg = (gidx >= start[:, None]) & (gidx < end[:, None]) \
                & active[:, None]
            # Aligned windows reach rows outside the tile's segment, up to cs
            # past the last pair; those rows count as zero and are never
            # used, since the gather kernel leaves the ones past the last
            # segment unwritten.
            chunk = torch.where(in_seg[..., None],
                                sorted_payload[gidx.clamp(max=p - 1)],
                                0.0)                                 # (B, CS, 16)
            mx = (chunk[..., 0] - ox)[:, None, :]
            my = (chunk[..., 1] - oy)[:, None, :]
            ca = chunk[..., 2][:, None, :]
            cb = chunk[..., 3][:, None, :]
            cc = chunk[..., 4][:, None, :]
            op = chunk[..., 5][:, None, :]
            dx = xl - mx
            dy = yl - my
            _, alpha_raw, live = alpha_gates(ca, cb, cc, op, dx, dy, cfg)
            live &= in_seg[:, None, :]                               # (B, PX, CS)
            alpha = torch.where(live, torch.clamp(alpha_raw, max=cfg.alpha_max),
                                torch.zeros_like(alpha_raw))
            ell = torch.log1p(-alpha)
            s_incl = torch.cumsum(ell, dim=2)
            t_in = torch.exp(s_incl - ell + log_t[..., None])
            w = alpha * t_in
            feats = torch.stack(
                [chunk[..., 6], chunk[..., 7], chunk[..., 8],
                 torch.ones_like(chunk[..., 0]), chunk[..., 10]], dim=-1)
            acc = acc + torch.bmm(w, feats)                          # (B, PX, 5)
            log_t = log_t + s_incl[..., -1]
            stop = stop + active.to(torch.int64)
            alive = torch.where(active, log_t.max(dim=1).values > log_eps, alive)
        rows = [acc[..., 0], acc[..., 1], acc[..., 2], log_t, acc[..., 3],
                acc[..., 4], stop.to(torch.float32)[:, None].expand(nb, px),
                torch.zeros_like(log_t)]
        blocks.append(torch.stack(rows, dim=1))
    out = torch.cat(blocks) if blocks else torch.zeros(
        (0, NOUT, px), dtype=torch.float32, device=device)
    if ablate == "noacc":
        keep = torch.zeros(NOUT, dtype=torch.bool, device=device)
        keep[[OUT_LOGT, OUT_STOP]] = True
        out = torch.where(keep[None, :, None], out, torch.zeros_like(out))
    return out


def rasterize_backward_torch(
    sorted_payload: torch.Tensor,   # (P, 16) rows in (tile, depth) order
    tile_starts: torch.Tensor,      # (T + 1,) int32
    cot_tiles: torch.Tensor,        # (T, NOUT, tile_px) rows dR, dG, dB, dlogT, dWsum, dDepth
    fwd_tiles: torch.Tensor,        # (T, NOUT, tile_px) the forward's block
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    ablate: str = "",
) -> torch.Tensor:
    """Plain version of K2. Returns the (P, 16) per-pair gradient rows:
    channels 0-5 (mean, conic, opacity) through alpha, 6-10 (r, g, b, the
    constant-1 weight channel, depth) directly, 11-15 zero. Rows of chunks
    the forward did not composite, and rows past tile_starts[-1], are zero.

    `ablate`: 'nogeom' zeroes channels 0-5, 'nodirect' channels 6-10, and
    'nograd' and 'dmaonly' every channel."""
    _ablate.check("backward", ablate)
    _ablate.no_plain_version("backward", ablate)
    if ablate in ("nograd", "dmaonly"):
        return torch.zeros((sorted_payload.shape[0], PAYLOAD_DIM),
                           dtype=torch.float32, device=sorted_payload.device)
    ts, cs = cfg.tile_size, cfg.chunk_size
    px = ts * ts
    tiles_x, tiles_y = tile_grid(width, height, ts)
    num_tiles = tiles_x * (tiles_y if tile_rows is None else tile_rows)
    device = sorted_payload.device
    p = sorted_payload.shape[0]

    out = torch.zeros((p, PAYLOAD_DIM), dtype=torch.float32, device=device)
    idx = torch.arange(px, device=device)
    xl = (idx % ts).to(torch.float32)[None, :, None]
    yl = (idx // ts).to(torch.float32)[None, :, None]
    lane = torch.arange(cs, device=device, dtype=torch.int64)

    starts_all = tile_starts[:-1].to(torch.int64)
    ends_all = tile_starts[1:].to(torch.int64)
    stops_all = fwd_tiles[:, OUT_STOP, 0].to(torch.int64)
    batch = max(1, _TILE_BATCH_ELEMS // (px * cs))
    for t0 in range(0, num_tiles, batch):
        t = torch.arange(t0, min(t0 + batch, num_tiles), device=device)
        start, end = starts_all[t], ends_all[t]
        base = torch.div(start, cs, rounding_mode="floor") * cs
        n_chunks = torch.div(end - base + cs - 1, cs, rounding_mode="floor")
        n_live = torch.minimum(stops_all[t], n_chunks)
        ox = ((t % tiles_x) * ts).to(torch.float32)[:, None]
        oy = ((t // tiles_x + tile_row0) * ts).to(torch.float32)[:, None]
        cot = cot_tiles[t]
        # Cotangents of the accumulated channels r, g, b, weight, depth.
        dacc = torch.stack([cot[:, 0], cot[:, 1], cot[:, 2], cot[:, 4],
                            cot[:, 5]], dim=-1)                   # (B, PX, 5)
        log_t = fwd_tiles[t, OUT_LOGT, :]                          # (B, PX)
        s_dlogt = cot[:, 3, :]                                      # (B, PX)
        for ci in reversed(range(int(n_live.max().item()) if t.numel() else 0)):
            active = ci < n_live
            gidx = base[:, None] + ci * cs + lane[None, :]          # (B, CS)
            in_seg = (gidx >= start[:, None]) & (gidx < end[:, None]) \
                & active[:, None]
            # Aligned windows reach rows outside the tile's segment, up to cs
            # past the last pair; those rows count as zero and are never
            # used, since the gather kernel leaves the ones past the last
            # segment unwritten.
            chunk = torch.where(in_seg[..., None],
                                sorted_payload[gidx.clamp(max=p - 1)],
                                0.0)                                 # (B, CS, 16)
            mx = (chunk[..., 0] - ox)[:, None, :]
            my = (chunk[..., 1] - oy)[:, None, :]
            ca = chunk[..., 2][:, None, :]
            cb = chunk[..., 3][:, None, :]
            cc = chunk[..., 4][:, None, :]
            op = chunk[..., 5]
            dx = xl - mx
            dy = yl - my
            _, alpha_raw, live = alpha_gates(ca, cb, cc, op[:, None, :], dx, dy,
                                             cfg)
            live &= in_seg[:, None, :]                               # (B, PX, CS)
            alpha = torch.where(live, torch.clamp(alpha_raw, max=cfg.alpha_max),
                                torch.zeros_like(alpha_raw))
            unclamped = live & (alpha_raw < cfg.alpha_max)
            ell = torch.log1p(-alpha)
            s_incl = torch.cumsum(ell, dim=2)
            log_t_start = log_t - s_incl[..., -1]
            t_in = torch.exp(s_incl - ell + log_t_start[..., None])
            w = alpha * t_in
            feats = torch.stack(
                [chunk[..., 6], chunk[..., 7], chunk[..., 8],
                 torch.ones_like(chunk[..., 0]), chunk[..., 10]], dim=-1)
            dw = torch.bmm(dacc, feats.transpose(1, 2))             # (B, PX, CS)
            d_se = dw * w
            # d logT of pair j: the pixel's carried dlogT plus d_se of every
            # later pair of the chunk (a strict suffix sum).
            suffix = torch.flip(torch.cumsum(torch.flip(d_se, [2]), dim=2), [2])
            d_ell = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])],
                              dim=2) + s_dlogt[..., None]
            dalpha = torch.where(unclamped, dw * t_in - d_ell / (1.0 - alpha),
                                 torch.zeros_like(alpha))
            dq = -0.5 * dalpha * alpha
            geom = torch.stack([
                (-2.0 * dq * (ca * dx + cb * dy)).sum(1),
                (-2.0 * dq * (cc * dy + cb * dx)).sum(1),
                (dq * dx * dx).sum(1),
                (2.0 * dq * dx * dy).sum(1),
                (dq * dy * dy).sum(1),
                -2.0 * dq.sum(1) / torch.clamp(op, min=1e-20),
            ], dim=1)                                               # (B, 6, CS)
            direct = torch.bmm(dacc.transpose(1, 2), w)             # (B, 5, CS)
            if ablate == "nogeom":
                geom = torch.zeros_like(geom)
            elif ablate == "nodirect":
                direct = torch.zeros_like(direct)
            rows = torch.cat([geom, direct, torch.zeros_like(direct)], dim=1)
            out[gidx[in_seg]] = rows.transpose(1, 2)[in_seg]
            log_t = torch.where(active[:, None], log_t_start, log_t)
            s_dlogt = torch.where(active[:, None], s_dlogt + d_se.sum(2), s_dlogt)
    return out


def max_chunks_needed(tile_starts: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """() int32: the longest tile segment, in chunks."""
    seg_len = tile_starts[1:] - tile_starts[:-1]
    return torch.div(seg_len.max() + chunk_size - 1, chunk_size,
                     rounding_mode="floor").to(torch.int32)
