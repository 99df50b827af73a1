"""K4, the pair expansion: CUDA kernel (csrc/expand.cu) and plain version.

For each pair slot p < capacity: the owner is the last depth rank g with
off_c[g] <= p; k = p - off_c[g] is replaced by the index of the k-th set bit
of g's survivor mask when the mask is non-zero; the tile is the rect origin
plus row-major k. Packed regime (tile_bits + rank_bits <= 31): one int32
key (tile << rank_bits) | g per slot, the sentinel num_tiles << rank_bits
past num_pairs. Otherwise two int32 streams: tile (num_tiles past
num_pairs) and g. Both versions define every slot, so they agree over the
whole capacity.

The kernel finds owners block by block (csrc/expand.cu): `warp_count_le`
and `block_owners` below are plain twins of that search, for the CPU tests.
"""

from __future__ import annotations

import bisect
import ctypes
from typing import Sequence

import torch

from .build import CudaKernel

I32 = torch.int32
_P = ctypes.c_void_p
_I = ctypes.c_int

# csrc/expand.cu's launch shape: 256 threads a block, four slots a thread.
SLOTS_PER_THREAD = 4
SLOTS_PER_BLOCK = 256 * SLOTS_PER_THREAD

EXPAND = CudaKernel(
    "expand.cu", "gs_expand_pairs",
    # off, rect, mask, num_pairs, n, capacity, tiles_x, rank_bits, sentinel,
    # by, bw, bh, packed, out_a, out_b, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane (torch has no popcount)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(I32)


def _kth_set_bit(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Index of the k-th (0-based) set bit of each int32 lane; 0 if there is
    no such bit."""
    cnt = torch.zeros_like(k)
    sel = torch.zeros_like(k)
    for bit in range(32):
        isset = (mask >> bit) & 1
        sel = torch.where((cnt == k) & (isset == 1), bit, sel)
        cnt = cnt + isset
    return sel


def expand_pairs_torch(off_c, rect_c, mask_c, num_pairs, capacity: int,
                       tiles_x: int, num_tiles: int, rank_bits: int,
                       pack_bits, packed: bool):
    """Plain PyTorch version of K4 (any device; int64 rects allowed)."""
    n = off_c.shape[0]
    pos = torch.arange(capacity, dtype=I32, device=off_c.device)
    g = torch.searchsorted(off_c, pos, right=True, out_int32=True) - 1
    g = torch.clamp(g, 0, n - 1)
    rect = rect_c[g]
    mask = mask_c[g]
    by, bw, bh = pack_bits
    xm = (rect >> (by + bw + bh)).to(I32)
    ym = ((rect >> (bw + bh)) & ((1 << by) - 1)).to(I32)
    tw = ((rect >> bh) & ((1 << bw) - 1)).to(I32)
    k = pos - off_c[g]
    k = torch.where(mask == 0, k, _kth_set_bit(mask, k))
    tw_s = torch.clamp(tw, min=1)
    tile = (ym + torch.div(k, tw_s, rounding_mode="floor")) * tiles_x \
        + xm + torch.remainder(k, tw_s)
    valid = pos < num_pairs
    if packed:
        sentinel = torch.full_like(tile, num_tiles << rank_bits)
        return torch.where(valid, (tile << rank_bits) | g, sentinel)
    return torch.where(valid, tile, torch.full_like(tile, num_tiles)), g


def warp_count_le(off: Sequence[int], key: int) -> int:
    """Plain twin of csrc/expand.cu `warp_count_le`: the number of entries
    of the non-decreasing `off` that are <= key, found by probing 32 evenly
    spaced entries of the remaining range a step (one per lane)."""
    lo, hi = 0, len(off)
    while lo < hi:
        span = hi - lo
        probes = [lo + ((span * (lane + 1)) >> 5) - 1 for lane in range(32)]
        j = sum(q < lo or off[q] <= key for q in probes)
        new_lo = lo + ((span * j) >> 5)
        if j < 32:
            hi = lo + ((span * (j + 1)) >> 5) - 1
        lo = new_lo
    return lo


def block_owners(off_c: torch.Tensor, num_pairs: int,
                 capacity: int) -> torch.Tensor:
    """Plain twin of csrc/expand.cu's owner search: the (capacity,) int32
    owner of every slot, as the kernel finds it (the rank stream of the
    separate regime). A block of SLOTS_PER_BLOCK slots wholly past
    num_pairs searches nothing (owner n - 1); otherwise g0 is the owner of
    its first slot by `warp_count_le`, the window is off[g0, g0 +
    SLOTS_PER_BLOCK), each thread bisects the window for its first slot and
    steps to the next rank for its later ones. Relies on what compact_rects
    guarantees: every rank whose offset is below num_pairs owns a slot."""
    off = [int(x) for x in off_c.tolist()]
    n = len(off)
    owners = [n - 1] * capacity
    for base in range(0, min(num_pairs, capacity), SLOTS_PER_BLOCK):
        g0 = max(warp_count_le(off, base) - 1, 0)
        win = off[g0:g0 + SLOTS_PER_BLOCK]
        for p0 in range(base, base + SLOTS_PER_BLOCK, SLOTS_PER_THREAD):
            if p0 >= num_pairs:
                break
            hi = min(len(win), p0 - base + 1)
            i = bisect.bisect_right(win, p0, 1, hi) - 1
            for p in range(p0, min(p0 + SLOTS_PER_THREAD, num_pairs)):
                while i + 1 < len(win) and win[i + 1] <= p:
                    i += 1
                owners[p] = g0 + i
    return torch.tensor(owners, dtype=I32)


def _check_i32(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != I32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def expand_pairs_cuda(off_c, rect_c, mask_c, num_pairs, capacity: int,
                      tiles_x: int, num_tiles: int, rank_bits: int,
                      pack_bits, packed: bool):
    """Launch K4 on the current stream. num_pairs stays on the device."""
    n = off_c.shape[0]
    for name, t in (("off_c", off_c), ("rect_c", rect_c), ("mask_c", mask_c)):
        _check_i32(name, t, (n,))
    _check_i32("num_pairs", num_pairs, ())
    if n < 1 or capacity < 1 or capacity > 2 ** 31 - SLOTS_PER_BLOCK:
        raise ValueError(f"expand needs n >= 1 and 1 <= capacity <= 2^31 - "
                         f"{SLOTS_PER_BLOCK} (n={n}, capacity={capacity})")
    out_a = torch.empty((capacity,), dtype=I32, device=off_c.device)
    out_b = out_a if packed else torch.empty_like(out_a)
    sentinel = num_tiles << rank_bits if packed else num_tiles
    by, bw, bh = pack_bits
    stream = torch.cuda.current_stream(off_c.device).cuda_stream
    EXPAND.launch(
        off_c.data_ptr(), rect_c.data_ptr(), mask_c.data_ptr(),
        num_pairs.data_ptr(), n, capacity, tiles_x, rank_bits, sentinel,
        by, bw, bh, int(packed), out_a.data_ptr(), out_b.data_ptr(), stream,
    )
    return out_a if packed else (out_a, out_b)
