"""The pair gather: CUDA kernel (csrc/gather.cu) and its plain version.

Both put the per-gaussian payload rows into sorted pair order,
out[i] = payload[depth_order[sorted_ranks[i]]], for the (P,) pair slots of
a `TileBinning`. The plain version is two `index_select`s over every slot
(rows past num_pairs then hold the sentinel rank's row). The kernel copies
only the slots below num_pairs, which it reads on the device, and leaves the
rows past it unwritten: nothing downstream reads them (the raster kernels
stop at `tile_starts[-1]` = num_pairs, and the gather's backward zeroes the
cotangent rows past it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
NCH = 16

GATHER = CudaKernel(
    "gather.cu", "gs_gather_pairs",
    # payload, depth_order, sorted_ranks, num_pairs, capacity, out, stream
    [_P, _P, _P, _P, _I, _P, _P],
)

__all__ = ["GATHER", "gather_pairs_cuda", "gather_pairs_torch"]


def gather_pairs_torch(payload: torch.Tensor, depth_order: torch.Tensor,
                       sorted_ranks: torch.Tensor,
                       num_pairs: torch.Tensor) -> torch.Tensor:
    """Plain version: the payload in depth order, then every slot's row
    (the slots past `num_pairs` too, which is not read)."""
    del num_pairs
    return payload.index_select(0, depth_order).index_select(0, sorted_ranks)


def _check(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_pairs_cuda(payload: torch.Tensor, depth_order: torch.Tensor,
                      sorted_ranks: torch.Tensor, num_pairs: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the gather on the current stream; returns the (P, 16) rows in
    sorted pair order, P = len(sorted_ranks). Rows at or past `num_pairs`
    (a () int32 device tensor, never read on the host) are not written:
    they hold whatever `out`, or a fresh `torch.empty`, held. The payload
    is (M, 16) float32, with M >= every entry of `depth_order`."""
    _check("payload", payload, torch.float32, 2)
    if payload.shape[1] != NCH:
        raise ValueError(f"payload rows must have {NCH} channels, got "
                         f"{payload.shape[1]}")
    _check("depth_order", depth_order, torch.int32, 1)
    _check("sorted_ranks", sorted_ranks, torch.int32, 1)
    _check("num_pairs", num_pairs, torch.int32, 0)
    p = sorted_ranks.shape[0]
    if out is None:
        out = torch.empty((p, NCH), dtype=torch.float32, device=payload.device)
    else:
        _check("out", out, torch.float32, 2)
        if tuple(out.shape) != (p, NCH):
            raise ValueError(f"out must have shape {(p, NCH)}, got "
                             f"{tuple(out.shape)}")
    tensors = dict(payload=payload, depth_order=depth_order,
                   sorted_ranks=sorted_ranks, num_pairs=num_pairs, out=out)
    for name, t in tensors.items():
        if t.device != payload.device or t.device.type != "cuda":
            raise ValueError(f"gather_pairs_cuda needs CUDA tensors on one "
                             f"device ({name} is on {t.device})")
    if payload.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("payload and out must be 16-byte aligned (the "
                         "kernel moves float4 quarters of a row)")
    if p >= 2 ** 31:
        raise ValueError(f"the gather indexes pair slots with int32 (P={p})")
    if p == 0:
        return out
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    GATHER.launch(payload.data_ptr(), depth_order.data_ptr(),
                  sorted_ranks.data_ptr(), num_pairs.data_ptr(), p,
                  out.data_ptr(), stream)
    return out
