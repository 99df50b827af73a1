"""Static-capacity tile binning: compact -> expand -> sort -> segments.

1. Per-gaussian tile rectangles from the per-axis extents, clipped to the
   tile grid (or a strip of it), with an exact per-tile survivor mask and
   the pair count (the R kernel, ops/kernels/rects.py, or its plain
   version `tile_rects_torch`).
2. One compaction sort: gaussians that emit pairs first, by depth, ties by
   original index. The position in that order is the depth rank.
3. The pair expansion (the K4 kernel, ops/kernels/expand.py) fills a
   fixed-capacity list with one (tile, rank) key per pair; pairs past the
   capacity are counted in `overflow`, never reallocated.
4. One stable sort of the keys gives per-tile, front-to-back pair lists, and
   a searchsorted gives each tile's segment.

The binning itself is integer order data: no gradient flows through it. The
payload gather into sorted pair order (the pair gather kernel,
ops/kernels/gather.py, over the binned pairs only) is differentiable by its
own `torch.autograd.Function`, whose backward sums each gaussian's per-pair
gradient rows in a fixed order (`reduce_pair_grads`, with the K3 segment
reduce kernel, ops/kernels/segreduce.py) instead of autograd's scatter-add.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import RasterConfig
from .kernels.expand import expand_pairs_cuda, expand_pairs_torch, popcount
from .kernels.gather import gather_pairs_cuda, gather_pairs_torch
from .kernels.rects import MASK_TILES, tile_rects_cuda
from .kernels.segreduce import segment_reduce_pairs_cuda, segment_reduce_pairs_torch
from .projection import Projected
from ..utils.logging import span

I32 = torch.int32


def resolve_impl(impl: str, device: torch.device) -> str:
    """'auto' -> 'cuda' for CUDA tensors, 'torch' for CPU tensors. 'cuda'
    needs CUDA tensors; 'torch' (the plain versions) runs anywhere."""
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {device}")
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown rasterizer impl: {impl!r}")
    return impl


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    """Number of tiles along x and y."""
    return (-(-width // tile_size), -(-height // tile_size))


def tile_ranges(mean2d, radius_xy, tile_size: int, tiles_x: int, tiles_y: int):
    """Inclusive-min / exclusive-max tile rectangle per gaussian, covering
    the axis-aligned box of the support ellipse. Returns int32 (xmin, ymin,
    xmax, ymax); empty where either extent is 0."""
    rx = radius_xy[:, 0].to(torch.float32)
    ry = radius_xy[:, 1].to(torch.float32)
    u, v = mean2d[:, 0], mean2d[:, 1]
    xmin = torch.clamp(torch.floor((u - rx) / tile_size), 0, tiles_x).to(I32)
    ymin = torch.clamp(torch.floor((v - ry) / tile_size), 0, tiles_y).to(I32)
    xmax = torch.clamp(torch.floor((u + rx) / tile_size) + 1, 0, tiles_x).to(I32)
    ymax = torch.clamp(torch.floor((v + ry) / tile_size) + 1, 0, tiles_y).to(I32)
    empty = (radius_xy[:, 0] <= 0) | (radius_xy[:, 1] <= 0)
    xmax = torch.where(empty, xmin, torch.maximum(xmax, xmin))
    ymax = torch.where(empty, ymin, torch.maximum(ymax, ymin))
    return xmin, ymin, xmax, ymax


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _rect_qmin(ca, cb, cc, x0, x1, y0, y1):
    """Exact minimum of the positive-definite form q(d) = ca dx^2 +
    2 cb dx dy + cc dy^2 over the rectangle [x0,x1] x [y0,y1] (coordinates
    relative to the splat centre): minimize along the two faces nearest the
    origin. Denominators are clamped so a zero conic gives qmin = 0."""
    ca_s = torch.clamp(ca, min=1e-12)
    cc_s = torch.clamp(cc, min=1e-12)
    zero = torch.zeros_like(x0)
    xe = _clip(zero, x0, x1)
    ye = _clip(zero, y0, y1)
    ys = _clip(-cb * xe / cc_s, y0, y1)
    q1 = ca * xe * xe + 2.0 * cb * xe * ys + cc * ys * ys
    xs = _clip(-cb * ye / ca_s, x0, x1)
    q2 = ca * xs * xs + 2.0 * cb * xs * ye + cc * ye * ye
    return torch.minimum(q1, q2)


def _tile_survivor_mask(
    mean2d, conic, opacity,      # (N, 2), (N, 3), (N,) detached values
    xmin, ymin, tw, th,          # (N,) int32 strip-clipped rect (tiles)
    tile_row0: int,
    tile_size: int,
    sigma_radius: float,
    alpha_min: float,
) -> torch.Tensor:
    """(N,) int32 bitmask of rect-local tiles (bit b = ky*tw + kx) whose
    pixel square meets the visible support {q <= min(sigma_radius^2,
    2 ln(op/alpha_min))}; the rasterizers zero every contribution outside
    it, so dropping the other tiles leaves the image unchanged."""
    f32 = torch.float32
    u = mean2d[:, 0:1]
    v = mean2d[:, 1:2]
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    tau = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))[:, None]
                 - float(math.log(alpha_min)))
    tau = torch.clamp(tau, max=sigma_radius * sigma_radius)
    bb = torch.arange(MASK_TILES, dtype=I32, device=xmin.device)[None, :]
    tw_s = torch.clamp(tw, min=1)[:, None]
    ky = torch.div(bb, tw_s, rounding_mode="floor")
    kx = bb - ky * tw_s
    x0 = ((xmin[:, None] + kx) * tile_size).to(f32) - u
    y0 = ((ymin[:, None] + ky + tile_row0) * tile_size).to(f32) - v
    qmin = _rect_qmin(ca, cb, cc, x0, x0 + tile_size, y0, y0 + tile_size)
    keep = (bb < (tw * th)[:, None]) & (qmin * 0.999 - 1e-2 <= tau)
    bits = torch.where(keep, torch.bitwise_left_shift(torch.ones_like(bb), bb),
                       torch.zeros_like(bb))
    # The bits are disjoint, so their sum is their OR (bit 31 is the sign).
    return bits.sum(dim=1, dtype=torch.int64).to(I32)


@dataclasses.dataclass
class CompactedRects:
    """Depth-ordered, compacted per-gaussian rects: the expansion's input."""

    order: torch.Tensor      # (N,) int32 depth rank -> original gaussian index
    off_c: torch.Tensor      # (N,) int32 capacity-clipped exclusive pair offsets
    rect_c: torch.Tensor     # (N,) packed (xmin, ymin, tw, th); int32, or
    #                          int64 on tile grids too large to pack in 31 bits
    mask_c: torch.Tensor     # (N,) int32 survivor mask (0 = dense rect)
    num_pairs: torch.Tensor  # () int32 pairs binned (<= capacity)
    overflow: torch.Tensor   # () int32 pairs dropped for capacity
    capacity: int
    tiles_x: int
    num_tiles: int
    rank_bits: int
    pack_bits: Tuple[int, int, int]   # (by, bw, bh) bit widths in the rect
    packed_keys: bool        # (tile << rank_bits | rank) fits 31 bits


def tile_rects_torch(mean2d, conic, opacity, depth, radius_xy, valid, cfg,
                     tiles_x: int, tiles_y: int, tile_row0: int,
                     tile_rows: int, pack_bits, rect_dtype):
    """Plain version of the R kernel (ops/kernels/rects.py): per gaussian
    the packed strip-clipped rect (0 where it emits no pair), the survivor
    mask (0 for a dense rect), the clamped pair count and the compaction
    sort's depth key (+inf where it emits no pair)."""
    xmin, ymin, xmax, ymax = tile_ranges(
        mean2d, radius_xy, cfg.tile_size, tiles_x, tiles_y)
    ymin = torch.clamp(ymin - tile_row0, 0, tile_rows)
    ymax = torch.clamp(ymax - tile_row0, 0, tile_rows)
    tw = xmax - xmin
    th = ymax - ymin
    counts = torch.clamp(tw * th, max=cfg.max_tiles_per_gaussian)
    counts = torch.where(valid, counts, torch.zeros_like(counts))

    if cfg.tile_cull and rect_dtype == I32:
        mask = _tile_survivor_mask(
            mean2d, conic, opacity, xmin, ymin, tw, th, tile_row0,
            cfg.tile_size, cfg.sigma_radius, cfg.alpha_min,
        )
        maskable = (counts > 0) & (tw * th <= MASK_TILES)
        surv = torch.clamp(popcount(mask), max=cfg.max_tiles_per_gaussian)
        counts = torch.where(maskable, surv, counts)
        mask = torch.where(maskable, mask, torch.zeros_like(mask))
    else:
        mask = torch.zeros_like(counts)

    # Empties fold to +inf depth, so the compaction sort puts them last.
    nonempty = counts > 0
    depth_key = torch.where(nonempty, depth, torch.full_like(depth, math.inf))
    by, bw, bh = pack_bits
    rdt = rect_dtype
    rect = ((((xmin.to(rdt) << by) | ymin.to(rdt)) << bw) | tw.to(rdt)) << bh \
        | th.to(rdt)
    rect = torch.where(nonempty, rect, torch.zeros_like(rect))
    return rect, mask, counts, depth_key


def compact_rects(
    proj: Projected,
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    capacity: Optional[int] = None,
    impl: str = "auto",
) -> CompactedRects:
    """Rects, survivor masks and pair counts (the R kernel, 'cuda', or its
    plain version, 'torch'), the compaction sort and the pair offsets."""
    impl = resolve_impl(impl, proj.mean2d.device)
    n = proj.mean2d.shape[0]
    if n < 1:
        raise ValueError("binning needs at least one gaussian slot")
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
    if tile_rows is None:
        tile_rows = tiles_y
    num_tiles = tiles_x * tile_rows
    if capacity is None:
        capacity = cfg.pair_capacity(n)

    by = max(int(tile_rows).bit_length(), 1)
    bw = max(int(tiles_x).bit_length(), 1)
    bx, bh = bw, by
    rect_packable = bx + by + bw + bh <= 31
    if not rect_packable and bx + by + bw + bh > 63:
        raise ValueError(f"tile grid {tiles_x}x{tile_rows} too large to bin")

    rects = tile_rects_cuda if impl == "cuda" else tile_rects_torch
    rect, mask, counts, depth_key = rects(
        proj.mean2d.detach(), proj.conic.detach(), proj.opacity.detach(),
        proj.depth.detach(), proj.radius_xy, proj.valid, cfg, tiles_x,
        tiles_y, tile_row0, tile_rows, (by, bw, bh),
        I32 if rect_packable else torch.int64,
    )

    # Compaction + depth sort in one: the stable sort breaks ties by
    # original index.
    order = torch.sort(depth_key, stable=True).indices
    rect_c = rect[order]
    mask_c = mask[order]
    counts_c = counts[order]

    csum = torch.cumsum(counts_c, dim=0)       # int64
    offsets = csum - counts_c
    total = csum[-1]
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    rank_bits = max(int(n - 1).bit_length(), 1) if n > 1 else 1
    return CompactedRects(
        order=order.to(I32),
        off_c=torch.clamp(offsets, max=capacity).to(I32),
        rect_c=rect_c,
        mask_c=mask_c,
        num_pairs=torch.clamp(total, max=capacity).to(I32),
        overflow=torch.clamp(total - capacity, min=0).to(I32),
        capacity=capacity,
        tiles_x=tiles_x,
        num_tiles=num_tiles,
        rank_bits=rank_bits,
        pack_bits=(by, bw, bh),
        packed_keys=tile_bits + rank_bits <= 31,
    )


def expand_compacted(c: CompactedRects, impl: str):
    """Run the pair expansion on compacted rects: the K4 kernel ('cuda') or
    its plain version ('torch'), for int32 and int64 rects alike. Returns
    the packed keys, or (tile, rank)."""
    fn = expand_pairs_cuda if impl == "cuda" else expand_pairs_torch
    return fn(c.off_c, c.rect_c, c.mask_c, c.num_pairs, c.capacity,
              c.tiles_x, c.num_tiles, c.rank_bits, c.pack_bits,
              c.packed_keys)


@dataclasses.dataclass
class TileBinning:
    """Sorted (tile, depth)-keyed pair list with per-tile segment offsets.
    Pair indices are depth ranks; `depth_order` maps rank -> original index.
    The valid pairs are the slots [0, num_pairs), and tile_starts[-1] is
    num_pairs: the gathered payload's rows past it are left unwritten on
    CUDA, and no reader may use them."""

    sorted_ranks: torch.Tensor  # (P,) int32 depth rank per pair (garbage past num_pairs)
    depth_order: torch.Tensor   # (N,) int32 depth rank -> original gaussian index
    sorted_tiles: torch.Tensor  # (P,) int32 tile per pair (num_tiles past the end)
    tile_starts: torch.Tensor   # (num_tiles + 1,) int32 segment offsets
    num_pairs: torch.Tensor     # () int32 valid pairs binned (<= capacity)
    overflow: torch.Tensor      # () int32 pairs dropped (capacity exceeded)
    sorted_pos: torch.Tensor    # (P,) int32 pre-sort pair position per sorted slot
    seg_offsets: torch.Tensor   # (N + 1,) int32 pre-sort segment start per rank

    def gather_payload(self, payload: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
        """Per-gaussian payload rows in sorted pair order, (P, 16):
        payload[depth_order][sorted_ranks]. With 'cuda' the gather kernel
        writes only the rows below num_pairs and leaves the rest unwritten
        (nothing reads them); the plain version ('torch') fills every row.

        Differentiable: the backward is `reduce_pair_grads`, with the K3
        kernel ('cuda') or its plain version ('torch'); 'auto' picks by the
        payload's device."""
        return _GatherSorted.apply(payload, self,
                                   resolve_impl(impl, payload.device))


def reduce_pair_grads(
    dsorted: torch.Tensor,       # (P, 16) per-pair cotangents, sorted pair order
    depth_order: torch.Tensor,   # (N,) int32 depth rank -> original index
    sorted_pos: torch.Tensor,    # (P,) int32 pre-sort position per sorted slot
    seg_offsets: torch.Tensor,   # (N + 1,) int32 pre-sort segment starts
    num_pairs: torch.Tensor,     # () int32
    impl: str,                   # 'cuda' (K3) or 'torch' (plain version)
) -> torch.Tensor:
    """Deterministic per-gaussian sum of per-pair gradient rows, in
    original gaussian order (N, 16).

    Un-permutes the rows to pre-sort order (a scatter through `sorted_pos`),
    where each depth rank's pairs are contiguous and the valid pairs sit at
    [0, num_pairs); zeroes the rows past num_pairs (garbage must not reach
    the sums); sums each rank's segment [seg_offsets[r], seg_offsets[r+1])
    in f32 (K3); and maps depth rank back to the original index (a scatter
    through `depth_order`). Both are full permutations, so each scatter
    writes every row once and is exact and deterministic. No row is rounded
    below f32."""
    p = dsorted.shape[0]
    n = depth_order.shape[0]
    dpre = torch.empty_like(dsorted).index_copy_(0, sorted_pos.long(), dsorted)
    valid = torch.arange(p, dtype=torch.int32, device=dsorted.device) < num_pairs
    dpre.masked_fill_(~valid[:, None], 0.0)
    reduce = segment_reduce_pairs_cuda if impl == "cuda" else segment_reduce_pairs_torch
    dpay_rank = reduce(dpre, seg_offsets, n)
    return torch.empty_like(dpay_rank).index_copy_(0, depth_order.long(),
                                                   dpay_rank)


class _GatherSorted(torch.autograd.Function):
    """payload[depth_order][sorted_ranks], by the gather kernel ('cuda':
    rows past num_pairs unwritten) or its plain version ('torch'); backward:
    reduce_pair_grads, which zeroes the cotangent rows past num_pairs."""

    @staticmethod
    def forward(ctx, payload, binning, impl):
        ctx.binning, ctx.impl = binning, impl
        gather = gather_pairs_cuda if impl == "cuda" else gather_pairs_torch
        return gather(payload.contiguous(), binning.depth_order,
                      binning.sorted_ranks, binning.num_pairs)

    @staticmethod
    def backward(ctx, dsorted):
        b = ctx.binning
        with span("gs.gather.bwd"):
            dpayload = reduce_pair_grads(dsorted.contiguous(), b.depth_order,
                                         b.sorted_pos, b.seg_offsets,
                                         b.num_pairs, ctx.impl)
        return dpayload, None, None


def sort_pairs(c: CompactedRects, expanded) -> TileBinning:
    """Stable sort of the expanded pairs by (tile, rank), then segments.
    Valid pairs sit at pre-sort positions [0, num_pairs)."""
    rank_mask = (1 << c.rank_bits) - 1
    if c.packed_keys:
        key = expanded
    else:
        tile, rank = expanded
        key = (tile.to(torch.int64) << c.rank_bits) | rank.to(torch.int64)
    sorted_key, idx = torch.sort(key, stable=True)
    sorted_tiles = (sorted_key >> c.rank_bits).to(I32)
    sorted_ranks = (sorted_key & rank_mask).to(I32)
    return _finish_binning(sorted_ranks, c.order, sorted_tiles, idx.to(I32),
                           c.off_c, c.num_pairs, c.overflow, c.num_tiles)


def bin_gaussians(
    proj: Projected,
    width: int,
    height: int,
    cfg: RasterConfig,
    tile_row0: int = 0,
    tile_rows: Optional[int] = None,
    capacity: Optional[int] = None,
    impl: str = "auto",
) -> TileBinning:
    """Bin into the full tile grid, or into a strip of `tile_rows` tile rows
    starting at `tile_row0`."""
    impl = resolve_impl(impl, proj.mean2d.device)
    c = compact_rects(proj, width, height, cfg, tile_row0, tile_rows, capacity,
                      impl)
    return sort_pairs(c, expand_compacted(c, impl))


def _finish_binning(
    sorted_ranks, order, sorted_tiles, sorted_pos, off_c,
    num_pairs, overflow, num_tiles,
) -> TileBinning:
    tiles = torch.arange(num_tiles + 1, dtype=I32, device=sorted_tiles.device)
    tile_starts = torch.searchsorted(sorted_tiles, tiles, right=False,
                                     out_int32=True)
    return TileBinning(
        sorted_ranks=sorted_ranks,
        depth_order=order,
        sorted_tiles=sorted_tiles,
        tile_starts=tile_starts,
        num_pairs=num_pairs,
        overflow=overflow,
        sorted_pos=sorted_pos,
        seg_offsets=torch.cat([off_c, num_pairs[None]]),
    )
