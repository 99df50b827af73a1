"""K3, the segment reduction of the payload-gather VJP: CUDA kernel
(csrc/segreduce.cu) and its plain version.

Input: the (P, 16) f32 per-pair gradient rows in PRE-SORT order (each depth
rank's pairs contiguous, rows >= num_pairs zero) and the (N + 1,) int32
segment offsets (`TileBinning.seg_offsets`, the last one num_pairs).
Output: (N, 16), row r the sum of rows [seg[r], seg[r+1]).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
NCH = 16

SEGREDUCE = CudaKernel(
    "segreduce.cu", "gs_segment_reduce",
    [_P, _P, _I, _P, _P],   # rows, seg_offsets, n, out, stream
)

__all__ = ["SEGREDUCE", "segment_reduce_pairs_cuda", "segment_reduce_pairs_torch"]


def segment_reduce_pairs_torch(rows: torch.Tensor, seg_offsets: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Plain version of K3: each row's rank by a search over the offsets,
    then `index_add_` (in row order on the CPU). Rows past the last offset
    are left out."""
    p = rows.shape[0]
    pos = torch.arange(p, dtype=torch.int32, device=rows.device)
    rank = torch.searchsorted(seg_offsets, pos, right=True, out_int32=True) - 1
    valid = (pos < seg_offsets[-1])[:, None]
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, torch.clamp(rank, 0, n - 1), rows)


def segment_reduce_pairs_cuda(rows: torch.Tensor, seg_offsets: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Launch K3 on the current stream; returns (n, 16)."""
    for name, t in (("rows", rows), ("seg_offsets", seg_offsets)):
        if t.device.type != "cuda":
            raise ValueError(f"segment_reduce_pairs_cuda needs CUDA tensors "
                             f"({name} is on {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    SEGREDUCE.launch(rows.data_ptr(), seg_offsets.data_ptr(), n,
                     out.data_ptr(), stream)
    return out
