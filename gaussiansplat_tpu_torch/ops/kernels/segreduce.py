"""K3, the segment reduction of the payload-gather VJP: CUDA kernel
(csrc/segreduce.cu) and its plain version.

Input: the (P, 16) f32 per-pair gradient rows in PRE-SORT order (each depth
rank's pairs contiguous, rows >= num_pairs zero) and the (N + 1,) int32
segment offsets (`TileBinning.seg_offsets`, the last one num_pairs).
Output: (N, 16), row r the sum of rows [seg[r], seg[r+1]).

`segment_reduce_pairs_split` is the plain twin of the kernel's summation
order (segments longer than LONG_ROWS split into GROUPS pieces), bit for
bit; `segment_reduce_pairs_torch` is the function. `ablate=` selects a
timing variant (ops/kernels/ablate.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import ablate as _ablate
from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
NCH = 16
# csrc/segreduce.cu's partition: 64 thread groups a block (four threads a
# rank); a segment longer than LONG_ROWS rows is split into one contiguous
# piece per group.
GROUPS = 64
LONG_ROWS = 32

SEGREDUCE = CudaKernel(
    "segreduce.cu", "gs_segment_reduce",
    [_P, _P, _I, _P, _P],   # rows, seg_offsets, n, out, stream
)

__all__ = ["SEGREDUCE", "long_segment_pieces", "segment_reduce_pairs_cuda",
           "segment_reduce_pairs_split", "segment_reduce_pairs_torch"]


def segment_reduce_pairs_torch(rows: torch.Tensor, seg_offsets: torch.Tensor,
                               n: int, ablate: str = "") -> torch.Tensor:
    """Plain version of K3: each row's rank by a search over the offsets,
    then `index_add_` (in row order on the CPU). Rows past the last offset
    are left out. `ablate`: 'dmaonly' gives zeros (the variant's rows are
    under 1e-20), 'stacked' is production."""
    if _ablate.check("segreduce", ablate) == "dmaonly":
        return torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                           device=rows.device)
    p = rows.shape[0]
    pos = torch.arange(p, dtype=torch.int32, device=rows.device)
    rank = torch.searchsorted(seg_offsets, pos, right=True, out_int32=True) - 1
    valid = (pos < seg_offsets[-1])[:, None]
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, torch.clamp(rank, 0, n - 1), rows)


def long_segment_pieces(seg_offsets: torch.Tensor):
    """The segments that K3 splits, and their pieces: the ranks whose
    segment has more than LONG_ROWS rows, and (L, GROUPS + 1) int64 piece
    bounds, piece i of a segment [s, s + len) being rows [s + len * i //
    GROUPS, s + len * (i + 1) // GROUPS)."""
    seg = seg_offsets.to(torch.int64)
    start, length = seg[:-1], seg[1:] - seg[:-1]
    ranks = torch.nonzero(length > LONG_ROWS).flatten()
    i = torch.arange(GROUPS + 1, device=seg.device)
    bounds = start[ranks, None] + length[ranks, None] * i // GROUPS
    return ranks, bounds


def _sum_in_order(rows, first, count, steps: int):
    """Rows [first, first + count) summed in row order from +0, elementwise
    over any shape of `first`; rows past `count` add +0, which changes no
    sum (a sum started at +0 is never -0)."""
    acc = torch.zeros((*first.shape, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(steps):
        row = rows[torch.clamp(first + j, max=rows.shape[0] - 1)]
        acc = acc + torch.where((j < count)[..., None], row, 0.0)
    return acc


def segment_reduce_pairs_split(rows: torch.Tensor, seg_offsets: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Plain twin of K3's summation order, bit for bit: a segment of at
    most LONG_ROWS rows in row order; a longer one as GROUPS pieces, each
    in row order, the 8 pieces of a warp added by the kernel's shuffle tree
    (groups 4, 2, 1 apart) and the 8 warps' sums in warp order."""
    if rows.shape[0] == 0:
        return torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                           device=rows.device)
    seg = seg_offsets.to(torch.int64)
    start, length = seg[:-1], seg[1:] - seg[:-1]
    short = torch.where(length > LONG_ROWS, 0, length)
    out = _sum_in_order(rows, start, short, LONG_ROWS)
    ranks, bounds = long_segment_pieces(seg_offsets)
    if ranks.numel():
        plen = bounds[:, 1:] - bounds[:, :-1]
        part = _sum_in_order(rows, bounds[:, :-1], plen, int(plen.max()))
        v = part.view(ranks.numel(), GROUPS // 8, 8, rows.shape[1])
        v = v[:, :, :4] + v[:, :, 4:]
        v = v[:, :, :2] + v[:, :, 2:]
        v = v[:, :, 0] + v[:, :, 1]
        total = v[:, 0]
        for w in range(1, GROUPS // 8):
            total = total + v[:, w]
        out[ranks] = total
    return out


def segment_reduce_pairs_cuda(rows: torch.Tensor, seg_offsets: torch.Tensor,
                              n: int, ablate: str = "") -> torch.Tensor:
    """Launch K3 on the current stream; returns (n, 16). `ablate` names a
    timing variant (ops/kernels/ablate.py), launched from its own build and
    counted on its own kernel; '' is production."""
    _ablate.check("segreduce", ablate)
    for name, t in (("rows", rows), ("seg_offsets", seg_offsets)):
        if t.device.type != "cuda":
            raise ValueError(f"segment_reduce_pairs_cuda needs CUDA tensors "
                             f"({name} is on {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (the kernel loads "
                         "float4 quarters of a row)")
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[1] != NCH:
        raise ValueError(f"rows must be (P, {NCH}) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if seg_offsets.dtype != torch.int32 or tuple(seg_offsets.shape) != (n + 1,):
        raise ValueError(f"seg_offsets must be ({n + 1},) int32, got "
                         f"{tuple(seg_offsets.shape)} {seg_offsets.dtype}")
    if n * NCH >= 2 ** 31 or rows.shape[0] >= 2 ** 31:
        raise ValueError(f"segment reduce indexes with int32 (n={n}, "
                         f"P={rows.shape[0]})")
    out = torch.empty((n, NCH), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    kernel = (_ablate.variant_kernel("segreduce", SEGREDUCE, ablate) if ablate
              else SEGREDUCE)
    kernel.launch(rows.data_ptr(), seg_offsets.data_ptr(), n,
                     out.data_ptr(), stream)
    return out
