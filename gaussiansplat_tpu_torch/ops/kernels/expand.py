"""K4, the pair expansion: CUDA kernel (csrc/expand.cu) and plain version.

For each pair slot p < capacity: the owner is the last depth rank g with
off_c[g] <= p; k = p - off_c[g] is replaced by the index of the k-th set bit
of g's survivor mask when the mask is non-zero; the tile is the rect origin
plus row-major k. Packed regime (tile_bits + rank_bits <= 31): one int32
key (tile << rank_bits) | g per slot, the sentinel num_tiles << rank_bits
past num_pairs. Otherwise two int32 streams: tile (num_tiles past
num_pairs) and g. Both versions define every slot, so they agree over the
whole capacity.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

I32 = torch.int32
_P = ctypes.c_void_p
_I = ctypes.c_int

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
    if n < 1 or capacity < 1:
        raise ValueError(f"expand needs n >= 1 and capacity >= 1 (n={n}, "
                         f"capacity={capacity})")
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
