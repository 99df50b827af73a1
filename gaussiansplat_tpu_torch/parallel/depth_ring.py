"""Depth-sliced ring compositing across gaussian shards.

The second gaussian-axis schedule beside gauss_shard's strip routing
(which keeps pixels stationary): every rank owns 1/D of the gaussians,
renders the FULL tile grid for one DEPTH SLAB, and the slab partials are
composited across ranks with the associative (colour, transmittance)
combiner

    C = C_front + T_front * C_back        T = T_front * T_back

passed around the ring with point-to-point sends. The slabs are
equal-count quantiles of a global log-depth histogram (one small
all-reduce), so composing the partials front to back reproduces the global
depth order: per pixel the result matches the single-device render to
float tolerance. One caveat: gaussians with equal depth bins near a slab
bound may composite in another tie order than the single-device (depth,
index) sort; distinct depths are exact.

Everything is differentiable: the slab routing indices are order data (no
gradient, like tile binning), the payloads flow through `AllToAll`, the
ring through `Permute` (backward: the inverse permutation) and the result
through `Broadcast`, and each slab's raster runs K4 and K1 forward, K2 and
K3 backward. Each parameter gradient lands on the rank that owns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RasterConfig
from ..models.gaussians import GaussianModel
from ..ops.binning import bin_gaussians
from ..ops.camera import Camera
from ..ops.projection import (
    PAYLOAD_DIM,
    make_payload,
    payload_to_projected,
    project_gaussians,
)
from ..ops.raster_dispatch import rasterize_payload
from .gauss_shard import pack_to_destinations
from .mesh import GAUSS_AXIS, AllToAll, Broadcast, Mesh, Permute, all_reduce
from .render import resolve_shard_impl

# The slab quantiles' log-depth histogram: 512 bins over [HIST_ZMIN,
# HIST_ZMAX], ~2.7% of depth per bin. Slab bounds fall on bin edges, which
# moves only the load balance, never correctness (a bin goes to one slab).
HIST_BINS = 512
HIST_ZMIN = 1e-2
HIST_ZMAX = 1e5


def _depth_bin(depth: torch.Tensor) -> torch.Tensor:
    """(n,) int32 histogram bin of each camera depth, in f32 as the
    reference computes it."""
    lo = np.log(HIST_ZMIN)
    hi = np.log(HIST_ZMAX)
    z = torch.log(torch.clamp(depth, HIST_ZMIN, HIST_ZMAX))
    b = torch.floor((z - float(lo)) / float(hi - lo) * HIST_BINS)
    return torch.clamp(b, 0, HIST_BINS - 1).to(torch.int32)


def depth_slab_bounds(
    depth: torch.Tensor,   # (n_local,) camera-space depth
    valid: torch.Tensor,   # (n_local,) bool
    n_slabs: int,
    group,
) -> torch.Tensor:
    """Equal-count slab bounds as histogram-bin indices, (n_slabs - 1,)
    int32, the same on every rank of `group`: built from the histogram
    summed over it. Bound k is the first bin whose cdf reaches (k + 1) /
    n_slabs of the mass, computed in f32 (k * total may not fit 32 bits
    at scale; the rounding moves the balance by a few counts only)."""
    bins = _depth_bin(depth).long()
    hist = torch.bincount(bins[valid], minlength=HIST_BINS).to(torch.int32)
    hist = all_reduce(hist, "sum", group)
    cdf = torch.cumsum(hist, 0)
    frac = torch.arange(1, n_slabs, dtype=torch.float32,
                        device=depth.device) / n_slabs
    targets = frac * cdf[-1].to(torch.float32)
    return torch.searchsorted(cdf.to(torch.float32), targets,
                              right=False).to(torch.int32)


def pack_by_slab(
    payload: torch.Tensor,   # (n_local, 16)
    slab: torch.Tensor,      # (n_local,) destination slab, n_slabs = drop
    n_slabs: int,
    send_cap: int,
):
    """Fixed-shape (n_slabs, send_cap, 16) send buffer (no duplication: each
    gaussian lives in exactly one slab) plus the rows dropped."""
    n = payload.shape[0]
    return pack_to_destinations(
        payload, slab, torch.arange(n, device=payload.device), n_slabs,
        send_cap)


def _compose(front: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """Front-over-back compositing of (..., 4) (R, G, B, logT) partials:
    C = C_f + T_f C_b, logT = logT_f + logT_b."""
    return torch.cat([front[..., :3] + torch.exp(front[..., 3:]) * back[..., :3],
                      front[..., 3:] + back[..., 3:]], dim=-1)


def render_depth_ring(
    model: GaussianModel,
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int,
    background: torch.Tensor,
    n_slabs: int,
    send_cap: int,
    mesh: Mesh,
    axis_name: str = GAUSS_AXIS,
    impl: str = "auto",
):
    """One rank's part: project the local shard, route the payloads to
    their depth slab's owner, rasterize the full grid for this rank's slab
    over black, compose the (C, logT) partials around the ring and
    broadcast rank 0's. Returns the replicated (image, trans, aux)."""
    group = mesh.group(axis_name)
    proj = project_gaussians(
        model.means, model.quats, model.log_scales, model.logit_opacities,
        model.sh, camera, cfg, sh_degree=sh_degree, alive=model.alive,
    )
    payload = make_payload(proj)                        # (n_local, 16)

    depth = proj.depth.detach()
    valid = proj.valid & (proj.radius > 0)
    bounds = depth_slab_bounds(depth, valid, n_slabs, group)
    slab = (_depth_bin(depth)[:, None] > bounds[None, :]).sum(1)
    slab = torch.where(valid, slab, n_slabs)            # culled: dropped

    send, pack_overflow = pack_by_slab(payload, slab, n_slabs, send_cap)
    recv = AllToAll.apply(send, group)                  # (n_slabs, K, 16)
    flat = recv.reshape(n_slabs * send_cap, PAYLOAD_DIM)
    binning = bin_gaussians(
        payload_to_projected(flat), camera.width, camera.height, cfg,
        capacity=cfg.pair_capacity(flat.shape[0]), impl=impl,
    )
    out = rasterize_payload(
        flat, binning, torch.zeros_like(background), camera.width,
        camera.height, cfg, impl,
    )
    # Rendered over black: this slab's own partials.
    log_t = torch.log(torch.clamp(out.transmittance, min=1e-30))
    v = torch.cat([out.image, log_t[..., None]], dim=-1)   # (H, W, 4)

    # On rank i the accumulator composes the slabs [i, i + k) in ring
    # order, so only rank 0's (no wrap-around) is the whole composite. For
    # a power-of-two D the hops double: after hop s, acc_i covers
    # [i, i + 2^s), and rank i receives acc_{i + 2^s}, the adjacent
    # segment: log2(D) hops. Any other D: D - 1 rotations of the ORIGINAL
    # partials v.
    acc = v
    if n_slabs & (n_slabs - 1) == 0:
        span = 1
        while span < n_slabs:
            pairs = [(i, (i - span) % n_slabs) for i in range(n_slabs)]
            acc = _compose(acc, Permute.apply(acc, pairs, group))
            span *= 2
    else:
        for k in range(1, n_slabs):
            pairs = [(i, (i - k) % n_slabs) for i in range(n_slabs)]
            acc = _compose(acc, Permute.apply(v, pairs, group))
    full = Broadcast.apply(acc, 0, group)
    trans = torch.exp(full[..., 3])
    image = full[..., :3] + trans[..., None] * background
    aux = dict(
        radii=proj.radius,
        overflow=binning.overflow + pack_overflow,
        num_pairs=binning.num_pairs,
        max_chunks_needed=out.max_chunks_needed,
    )
    return image, trans, aux


def make_depth_ring_render(
    mesh: Mesh,
    cfg: RasterConfig,
    width: int,
    height: int,
    sh_degree: int,
    send_cap: Optional[int] = None,
    impl: Optional[str] = None,
):
    """Build `f(model, camera, background, with_aux=False) -> (image,
    trans[, aux])` over a model sharded on the mesh's gauss axis
    (`gauss_shard.shard_model`). The image is the same on every rank.
    aux: the local `radii`, the `overflow` summed and `max_chunks_needed`
    maxed over the gauss group."""
    nd = mesh.axis_size(GAUSS_AXIS)
    group = mesh.group(GAUSS_AXIS)

    def f(model, camera, background, with_aux: bool = False):
        if (camera.width, camera.height) != (width, height):
            raise ValueError(
                f"camera is {camera.width}x{camera.height} but this renderer "
                f"was built for {width}x{height}")
        if camera.device != model.device:
            camera = camera.to(model.device)
        # The local shard splits ~evenly over D slabs; 2x headroom.
        cap = send_cap if send_cap is not None else max(
            2 * model.capacity // nd, 256)
        img, trans, aux = render_depth_ring(
            model, camera, cfg, sh_degree, background, nd, cap, mesh,
            impl=resolve_shard_impl(impl if impl is not None else cfg.impl,
                                    model.device))
        if not with_aux:
            return img, trans
        return img, trans, dict(
            radii=aux["radii"],
            overflow=all_reduce(aux["overflow"], "sum", group),
            max_chunks_needed=all_reduce(aux["max_chunks_needed"], "max",
                                         group))

    return f
