"""Timing variants of the raster and reduce kernels (K1, K2, K3): each is
the production kernel with one cost component taken out, so the difference
of two times prices that component on the card.

A variant is a `-DGS_ABLATE_<NAME>` build of the production source
(csrc/forward.cu, backward.cu, segreduce.cu), with its own `CudaKernel`
and launch counter, built into `_build/` at its first launch. Without a
define the preprocessed production source is what it was. The wrappers
select one with `ablate=` (`rasterize_forward_cuda`,
`rasterize_backward_cuda`, `segment_reduce_pairs_cuda`); the plain versions
(`rasterize_forward_torch`, `rasterize_backward_torch`,
`segment_reduce_pairs_torch`) take the same argument. Nothing on the
render or training path passes it.

K1 (forward):
  dmaonly   stage every chunk's rows as raw copies, no extent, gates or
            compositing; logT never moves, so every chunk is streamed;
  noacc     gates, alpha, w and the logT sum, no channel accumulation
            (R, G, B, weight sum and depth under 1e-20);
  nowrite   the whole computation, the 8-row store replaced by one
            checksum a tile (`forward_checksums`).
K2 (backward):
  dmaonly   stage the live chunks and write zero rows (the dead tail's
            zero fill stays), no gate or gradient math;
  nograd    gates, alpha, the per-pixel logT rewind and t_in (the
            recompute), zero rows: no dw / dalpha chain, no reduction;
  nogeom    no geometric rows 0-5 (their sums, their share of the warp
            reduction, the opacity combine); dalpha and its divide kept;
  nodirect  no direct rows 6-10 (their sums and share of the reduction);
  nowrite   the whole computation, the row stores (and the dead tail's
            zero fill) replaced by one checksum a tile
            (`backward_checksums`).
K3 (segment reduce):
  dmaonly   the same float4 loads of every segment's rows, no sums kept;
  stacked   the reference's alias of production: the production library.

`decompose` turns the variants' times into the components that the
reference's `benchmarks/profile_bwd_ablate.py` derives.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .build import CudaKernel

FORWARD_VARIANTS = ("dmaonly", "noacc", "nowrite")
BACKWARD_VARIANTS = ("dmaonly", "nograd", "nogeom", "nodirect", "nowrite")
SEGREDUCE_VARIANTS = ("dmaonly", "stacked")
VARIANTS = {"forward": FORWARD_VARIANTS, "backward": BACKWARD_VARIANTS,
            "segreduce": SEGREDUCE_VARIANTS}
# Variants that are the production kernel under another name.
ALIASES = {("segreduce", "stacked")}
# Kernels whose launcher can pin a variant's occupancy (`variant_kernel`).
PINNABLE = ("forward", "backward")

# Variants of the reference that price a device of the TPU kernels which
# the Hopper kernels do not have.
TPU_ONLY = {
    "nopack": "the bf16 packing of the gradient rows (TPU backward kernel)",
    "nounpack": "the bf16 lane unpack of packed rows (TPU segment reduce)",
    "split1": "the three-way bf16 (Dekker) split of the MXU one-hot matmul "
              "(TPU segment reduce)",
    "constoh": "the one-hot matrix built for the MXU (TPU segment reduce)",
}

# Relative tolerance of a `nowrite` checksum against the sum of the
# production output of its tile, of that tile's sum of magnitudes: the
# kernel sums in another order (a thread's values in sequence, then a tree
# over the block), each order within ~(8 + log2 n) * 2^-24 of the exact sum.
CHECKSUM_RTOL = 1e-5

_CACHE: Dict[Tuple[str, str, str, Optional[int]], CudaKernel] = {}


def check(kernel: str, ablate: str) -> str:
    """`ablate` if it names a variant of `kernel` ('forward', 'backward',
    'segreduce') or is '' (production); else ValueError."""
    if ablate == "":
        return ablate
    names = VARIANTS[kernel]
    if ablate in names:
        return ablate
    if ablate in TPU_ONLY:
        raise ValueError(
            f"ablate={ablate!r} prices {TPU_ONLY[ablate]}, which the Hopper "
            f"kernels do not have; the {kernel} kernel's variants are "
            f"{', '.join(names)}")
    raise ValueError(f"unknown ablate={ablate!r} for the {kernel} kernel; "
                     f"accepted: '' (production), {', '.join(names)}")


def variant_kernel(kernel: str, base: CudaKernel, ablate: str,
                   blocks: Optional[int] = None) -> CudaKernel:
    """The cached `CudaKernel` of variant `ablate` of `base` (the production
    kernel of `kernel`): the same source built with -DGS_ABLATE_<NAME>, or
    with no define for an alias of production. Each variant has its own
    launch counter; a kernel's first launch builds its library.

    `blocks` (K1 and K2) pins the build to that many blocks per SM
    (-DGS_ABLATE_BLOCKS: the launcher pads the dynamic shared memory until
    no more fit), for a variant whose registers would fit more blocks than
    production's: its time then prices the component and not occupancy.
    The padding also shrinks the SM's L1 share, so compare a pinned
    variant with production pinned the same way (`ablate=''`). Launch a
    pinned build through the wrapper's production path (the module's
    kernel swapped for it, as compare_forward_builds.py does)."""
    check(kernel, ablate)
    if blocks is not None and kernel not in PINNABLE:
        raise ValueError(f"the {kernel} kernel's launcher takes no pinned "
                         "occupancy")
    key = (kernel, str(base.source), ablate, blocks)
    if key not in _CACHE:
        defines = (() if not ablate or (kernel, ablate) in ALIASES
                   else (f"GS_ABLATE_{ablate.upper()}",))
        if blocks is not None:
            defines += (f"GS_ABLATE_BLOCKS={int(blocks)}",)
        _CACHE[key] = CudaKernel(str(base.source), base.symbol, base.argtypes,
                                 defines=defines)
    return _CACHE[key]


def pinned_blocks_per_sm(k: CudaKernel) -> int:
    """Blocks per SM of a pinned build's last launch, by the occupancy
    API (`gs_ablate_blocks_per_sm`)."""
    return int(k.fn("gs_ablate_blocks_per_sm", argtypes=())())


def variant_kernels(kernel: str, base: CudaKernel) -> Dict[str, CudaKernel]:
    """Every variant of `kernel` by name (for `build_all`)."""
    return {v: variant_kernel(kernel, base, v) for v in VARIANTS[kernel]}


def no_plain_version(kernel: str, ablate: str) -> None:
    """Raise for `nowrite`, whose output is a checksum a tile: it has no
    plain version."""
    if ablate == "nowrite":
        raise ValueError(
            f"ablate={ablate!r} of the {kernel} kernel writes a checksum a "
            f"tile and has no plain version: hold it against "
            f"{kernel}_checksums of the production output")


def forward_checksums(block: torch.Tensor) -> torch.Tensor:
    """(T,) f64: the sum of each tile's (8, tile_px) production block, what
    K1's `nowrite` variant leaves in block[t, 0, 0]."""
    return block.to(torch.float64).sum(dim=(1, 2))


def backward_checksums(rows: torch.Tensor,
                       tile_starts: torch.Tensor) -> torch.Tensor:
    """(T,) f64: the sum of each tile's production gradient rows (all 16
    channels of rows [start, end)), what K2's `nowrite` variant leaves in
    rows[start, 0] of a non-empty tile."""
    starts = tile_starts.to(torch.int64)
    row_sums = rows[: int(starts[-1])].to(torch.float64).sum(dim=1)
    csum = torch.cat([row_sums.new_zeros(1), torch.cumsum(row_sums, 0)])
    return csum[starts[1:]] - csum[starts[:-1]]


def _abs_checksums(values: torch.Tensor, kernel: str,
                  tile_starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same sums over magnitudes: the scale of `CHECKSUM_RTOL`."""
    if kernel == "forward":
        return forward_checksums(values.abs())
    return backward_checksums(values.abs(), tile_starts)


def _read_checksums(out: torch.Tensor, kernel: str,
                   tile_starts: Optional[torch.Tensor] = None):
    """The checksums a `nowrite` launch left: (T,) f64 of K1's block[t, 0,
    0]; for K2 rows[start, 0] of each non-empty tile, and the mask of the
    non-empty tiles (an empty tile writes nothing)."""
    if kernel == "forward":
        return out[:, 0, 0].to(torch.float64), None
    starts = tile_starts.to(torch.int64)
    nonempty = starts[1:] > starts[:-1]
    first = torch.clamp(starts[:-1], max=max(out.shape[0] - 1, 0))
    return out[first, 0].to(torch.float64), nonempty


def _sub(a: float, b: float, digits: Optional[int]) -> float:
    return a - b if digits is None else round(a - b, digits)


def decompose(times_ms: Dict[str, float], kernel: str = "backward",
              digits: Optional[int] = None) -> Dict[str, float]:
    """The cost components priced by the variants' times.

    `times_ms` maps '<variant>_ms' (and 'full_ms', production) to ms, as
    the reference's record (`benchmarks/bwd_ablate_3m_r5.json`, 'variants')
    does; a component is left out when a time it needs is missing.
    `digits` rounds each difference, as the reference rounds to 2.

    backward (the arithmetic of profile_bwd_ablate.py:150-165):
      geom_chain_ms = full - nogeom,  direct_ms = full - nodirect,
      pack_ms = full - nopack,        write_path_ms = full - nowrite,
      all_grad_math_ms = full - nograd,
      recompute_ms = nograd - dmaonly, stream_floor_ms = dmaonly.
    forward:
      compositing_ms = full - noacc,  output_store_ms = full - nowrite,
      gates_ms = noacc - dmaonly (a lower estimate: dmaonly streams every
      chunk, production only those before the tile stops),
      stream_floor_ms = dmaonly.
    segreduce:
      adds_ms = full - dmaonly, stream_floor_ms = dmaonly.
    """
    t = times_ms
    full = t.get("full_ms")
    out: Dict[str, float] = {}
    if kernel == "backward":
        if full is not None:
            for v, label in (("nogeom", "geom_chain"), ("nodirect", "direct"),
                             ("nopack", "pack"), ("nowrite", "write_path")):
                if v + "_ms" in t:
                    out[label + "_ms"] = _sub(full, t[v + "_ms"], digits)
            if "nograd_ms" in t:
                out["all_grad_math_ms"] = _sub(full, t["nograd_ms"], digits)
        if "dmaonly_ms" in t and "nograd_ms" in t:
            out["recompute_ms"] = _sub(t["nograd_ms"], t["dmaonly_ms"], digits)
            out["stream_floor_ms"] = t["dmaonly_ms"]
    elif kernel == "forward":
        if full is not None:
            for v, label in (("noacc", "compositing"),
                             ("nowrite", "output_store")):
                if v + "_ms" in t:
                    out[label + "_ms"] = _sub(full, t[v + "_ms"], digits)
        if "dmaonly_ms" in t and "noacc_ms" in t:
            out["gates_ms"] = _sub(t["noacc_ms"], t["dmaonly_ms"], digits)
        if "dmaonly_ms" in t:
            out["stream_floor_ms"] = t["dmaonly_ms"]
    elif kernel == "segreduce":
        if full is not None and "dmaonly_ms" in t:
            out["adds_ms"] = _sub(full, t["dmaonly_ms"], digits)
        if "dmaonly_ms" in t:
            out["stream_floor_ms"] = t["dmaonly_ms"]
    else:
        raise ValueError(f"unknown kernel {kernel!r}: forward, backward or "
                         "segreduce")
    return out


# A variant's contract against the production kernel's output on the same
# inputs (`contract`): the rows it keeps within KEPT_RTOL of each row's
# largest entry (the tolerance of the reference's tests/test_ablate.py; bit
# for bit where the variant keeps production's order), the rows it drops at
# most DROPPED_ATOL, a checksum within CHECKSUM_RTOL.
KEPT_RTOL = 1e-6
DROPPED_ATOL = 1e-20
# The rows each variant keeps (K1: logT and the stop row of its block; K2
# and K3: channels of the gradient rows); it drops the others.
_KEPT = {
    ("forward", "noacc"): (3, 6), ("forward", "dmaonly"): (3, 6),
    ("backward", "nogeom"): tuple(range(6, 11)),
    ("backward", "nodirect"): tuple(range(0, 6)),
    ("backward", "nograd"): (), ("backward", "dmaonly"): (),
    ("segreduce", "dmaonly"): (), ("segreduce", "stacked"): tuple(range(16)),
}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def contract(kernel: str, ablate: str, out: torch.Tensor, full: torch.Tensor,
             tile_starts: Optional[torch.Tensor] = None,
             chunk_size: Optional[int] = None) -> dict:
    """How variant `ablate` of `kernel` launched on some inputs (`out`)
    meets its contract against production's output on the same inputs
    (`full`). K2's rows are compared below tile_starts[-1] (the rest is
    never written); K1's `dmaonly` stop row must count every chunk of the
    tile's segment (`tile_starts`, `chunk_size`), `noacc`'s logT and stop
    rows must be production's bits. Returns the measured figures, 'ok' and
    a line of text."""
    check(kernel, ablate)
    r: dict = {}
    if ablate == "nowrite":
        got, nonempty = _read_checksums(out, kernel, tile_starts)
        if kernel == "forward":
            want, scale = forward_checksums(full), _abs_checksums(full, kernel)
        else:
            n = int(tile_starts[-1])
            want = backward_checksums(full[:n], tile_starts)
            scale = _abs_checksums(full[:n], kernel, tile_starts)
        rel = (got - want).abs() / scale.clamp(min=1e-30)
        if nonempty is not None:
            rel = rel[nonempty]
        r["checksum_rel"] = float(rel.max()) if rel.numel() else 0.0
        r["ok"] = r["checksum_rel"] <= CHECKSUM_RTOL
        r["text"] = (f"checksums within {r['checksum_rel']:.3e} of the tile's "
                     f"sum of magnitudes (limit {CHECKSUM_RTOL})")
        return r
    if kernel == "forward":
        o, f = out.transpose(0, 1), full.transpose(0, 1)   # rows first
    elif kernel == "backward":
        n = int(tile_starts[-1])
        o, f = out[:n].t(), full[:n].t()
    else:
        o, f = out.t(), full.t()
    kept = list(_KEPT[(kernel, ablate)])
    dropped = [c for c in range(o.shape[0]) if c not in kept]
    r["dropped_max"] = float(o[dropped].abs().max()) if dropped and o.numel() else 0.0
    ok = r["dropped_max"] <= DROPPED_ATOL
    text = [f"dropped rows {dropped} max |x| {r['dropped_max']:.3e}"]
    if kernel == "forward":
        if ablate == "noacc":
            bits = _bits_equal(o[3], f[3]) and _bits_equal(o[6], f[6])
            r["logt_stop_bits_equal"] = bits
            ok &= bits
            text.append(f"logT and stop rows production's bits: {bits}")
        else:
            starts = tile_starts.to(torch.int64)
            base = starts[:-1] // chunk_size * chunk_size
            n_chunks = (starts[1:] - base + chunk_size - 1) // chunk_size
            r["chunks_streamed"] = int(n_chunks.sum())
            r["chunks_composited"] = int(f[6, :, 0].sum())
            r["logt_max"] = float(o[3].abs().max()) if o.numel() else 0.0
            streams_all = bool(torch.equal(o[6, :, 0].to(torch.int64), n_chunks))
            ok &= streams_all and r["logt_max"] == 0.0
            text.append(f"logT 0: {r['logt_max'] == 0.0}, stop row = every "
                        f"chunk ({r['chunks_streamed']} streamed, production "
                        f"composited {r['chunks_composited']}): {streams_all}")
    elif kept:
        scale = f[kept].abs().amax(dim=1).clamp(min=1e-30)[:, None]
        rel = ((o[kept] - f[kept]).abs() / scale)
        r["kept_rel"] = float(rel.max()) if rel.numel() else 0.0
        r["kept_bits_equal"] = _bits_equal(o[kept], f[kept])
        limit = 0.0 if ablate == "stacked" else KEPT_RTOL
        ok &= r["kept_rel"] <= limit
        if ablate == "stacked":
            ok &= r["kept_bits_equal"]
        text.append(f"kept rows {kept[0]}-{kept[-1]} within {r['kept_rel']:.3e} "
                    f"of each row's largest entry (limit {limit}), bit-equal: "
                    f"{r['kept_bits_equal']}")
    r["ok"] = bool(ok)
    r["text"] = "; ".join(text)
    return r
