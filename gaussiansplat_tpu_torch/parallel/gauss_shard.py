"""Gaussian-axis sharding: the scene's parameters partitioned across ranks.

The scaling path for scenes too large for one card's memory:

  * Every rank of the mesh's `gauss` axis owns a contiguous 1/D block of
    every model buffer (`shard_model`) and one horizontal strip of the tile
    grid.
  * Per frame, each rank projects only its own gaussians, packs the
    16-channel projected payloads by destination strip (a gaussian whose
    extent spans k strips is sent to each of them), and one `all_to_all`
    routes every payload to the strip owners whose pixels it touches. Only
    the screen-space payload moves, never the parameters.
  * The receiver bins the union of its arrivals with the ordinary (tile,
    depth) sort (K4) and rasterizes its strip (K1), so front-to-back order
    is exact with no cross-rank depth partitioning.
  * The exchange is differentiable: the pack is a gather (backward: a
    scatter-add), the all_to_all's backward is the reverse all_to_all (K2
    and K3 run in between on the receiver), so each rank receives the
    gradient rows of the payloads it owns and autograd continues into its
    own parameter block. No parameter-gradient all-reduce is needed.

Shapes are static: the per-destination send capacity is fixed and the rows
past it are counted (`pack_overflow`), as the binning counts its pairs.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..config import RasterConfig
from ..models.gaussians import GaussianModel
from ..ops.binning import bin_gaussians
from ..ops.camera import Camera
from ..ops.projection import (
    PAYLOAD_DIM,
    PAYLOAD_MY,
    PAYLOAD_RY,
    make_payload,
    payload_to_projected,
    project_gaussians,
)
from ..ops.raster_dispatch import rasterize_payload
from ..utils.logging import count, span
from .capacity import arrival_pair_capacity, plan_gauss_sharded
from .mesh import GAUSS_AXIS, AllToAll, Mesh, all_reduce, make_grid, off_card_bytes
from .render import _GatherStrips, check_strips, resolve_shard_impl

I32 = torch.int32


def _warn_on_overflow(pack_overflow: int) -> None:
    if pack_overflow > 0:
        sys.stderr.write(
            f"[gauss_shard] WARNING: exchange dropped {pack_overflow} payload "
            "rows (send_cap too small for this scene's strip concentration — "
            "raise send_fraction/send_cap)\n"
        )


def make_gauss_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D gauss mesh over the whole running world (a (1, D) grid whose
    minor axis is `gauss`); one rank, with no process group, when none is
    running. Every rank must call it."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return make_grid(1, n_devices, GAUSS_AXIS)


def shard_model(model: GaussianModel, mesh: Mesh) -> GaussianModel:
    """This rank's block of the model: rows [r C / D, (r + 1) C / D) of every
    buffer for gauss index r of D, the layout of a `P("gauss")` sharding.
    The model must be the same on every rank. Raises unless D divides the
    capacity C."""
    nd = mesh.axis_size(GAUSS_AXIS)
    cap = model.capacity
    if cap % nd:
        raise ValueError(f"the gauss axis ({nd}) must divide the capacity "
                         f"({cap})")
    local = cap // nd
    r0 = mesh.axis_index(GAUSS_AXIS) * local
    with torch.no_grad():
        block = {k: v[r0:r0 + local].clone()
                 for k, v in model.trainable().items()}
        alive = model.alive[r0:r0 + local].clone()
    return GaussianModel(**block, alive=alive)


def pack_to_destinations(
    payload: torch.Tensor,   # (n, 16) rows to gather from
    dest: torch.Tensor,      # (m,) destination per entry; n_dest = drop
    src_ids: torch.Tensor,   # (m,) payload row per entry
    n_dest: int,
    send_cap: int,
):
    """The fixed-capacity destination pack of the strip and depth-slab
    routers: a stable sort groups the entries by destination (in entry
    order within one), searchsorted finds each destination's run, and a
    masked row gather emits the (n_dest, send_cap, 16) send buffer, zeros
    past each run, plus the count of entries past send_cap. Differentiable
    w.r.t. `payload`."""
    m = dest.shape[0]
    device = payload.device
    if m == 0:
        return (payload.new_zeros((n_dest, send_cap, payload.shape[1])),
                torch.zeros((), dtype=I32, device=device))
    sorted_dest, perm = torch.sort(dest.detach(), stable=True)
    sorted_ids = src_ids[perm]
    starts = torch.searchsorted(
        sorted_dest, torch.arange(n_dest + 1, dtype=sorted_dest.dtype,
                                  device=device), right=False)
    seg_len = starts[1:] - starts[:-1]
    overflow = torch.clamp(seg_len - send_cap, min=0).sum().to(I32)

    slot = torch.arange(send_cap, device=device)[None, :]          # (1, K)
    gather_pos = torch.clamp(starts[:-1, None] + slot, 0, m - 1)
    ok = slot < seg_len[:, None]                                    # (n_dest, K)
    # A slot past its run reads a row of its own, zeroed below, and not
    # row 0: the gather's backward (an accumulating index_put, which adds
    # each run of one repeated row serially) would otherwise add millions
    # of zeros into row 0 one by one.
    spare = (torch.arange(n_dest * send_cap, device=device)
             % payload.shape[0]).reshape(n_dest, send_cap)
    gidx = torch.where(ok, sorted_ids[gather_pos].long(), spare)
    send = torch.where(ok[..., None], payload[gidx], 0.0)
    return send, overflow


def pack_by_strip(
    payload: torch.Tensor,   # (n, 16) local projected payload
    bounds,                  # n_strips + 1 pixel-row bounds of the strips
    send_cap: int,           # per-destination row capacity
    expand_cap: int,         # (gaussian, strip) pair capacity
):
    """Route local payload rows to destination strips, strip s being the
    pixel rows [bounds[s], bounds[s + 1]): a fixed-shape (n_strips,
    send_cap, 16) send buffer, the rows dropped and the (gaussian, strip)
    entries asked for before any cap. A gaussian whose y-extent (the
    per-axis ellipse extent PAYLOAD_RY, as the receiver's binning rects)
    spans k strips is duplicated into k entries; the entries past
    `expand_cap` are dropped and counted as the reference's fixed-length
    `jnp.repeat` does."""
    n = payload.shape[0]
    n_strips = len(bounds) - 1
    device = payload.device
    mean_y = payload[:, PAYLOAD_MY].detach()
    ry = payload[:, PAYLOAD_RY].detach()
    edges = torch.as_tensor(bounds, dtype=mean_y.dtype, device=device)
    # The first strip that the extent reaches and one past the last: the
    # strips that end at or above its top, and those that start at or
    # above its bottom.
    s0 = torch.searchsorted(edges[1:], mean_y - ry, right=True).to(I32)
    s1 = torch.searchsorted(edges[:-1], mean_y + ry, right=True).to(I32)
    s1 = torch.where(ry > 0, torch.maximum(s1, s0), s0)
    counts = (s1 - s0).long()

    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    expand_overflow = torch.clamp(total - expand_cap, min=0)

    # Entry `pos` belongs to the gaussian whose run [end - count, end)
    # holds it (a static-length repeat_interleave of the ids).
    pos = torch.arange(expand_cap, device=device)
    ids = torch.clamp(torch.searchsorted(ends, pos, right=True), max=n - 1)
    k = pos - (ends - counts)[ids]
    in_range = (pos < torch.clamp(total, max=expand_cap)) & (k >= 0) & (k < counts[ids])
    dest = torch.where(in_range, s0[ids].long() + k, n_strips)

    send, send_overflow = pack_to_destinations(payload, dest, ids, n_strips,
                                               send_cap)
    return send, (expand_overflow + send_overflow).to(I32), total


def render_gauss_sharded_strip(
    model: GaussianModel,
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int,
    background: torch.Tensor,
    bounds,
    send_cap: int,
    mesh: Mesh,
    axis_name: str = GAUSS_AXIS,
    mean2d_offset: Optional[torch.Tensor] = None,   # (n_local, 2)
    impl: str = "auto",
):
    """One rank's part: project the local shard, exchange payloads over the
    mesh's `axis_name` group, bin (K4) and rasterize (K1) this rank's strip,
    tile rows [bounds[d], bounds[d + 1]) for gauss index d (`bounds`, the
    n_strips + 1 tile-row bounds of `strip_bounds`). Returns (strip image,
    strip transmittance, aux); aux has the local radii and this rank's
    overflow counts. Spans (utils/logging.py): `gs.project`, `gs.pack`,
    `gs.exchange` (its backward `gs.exchange.bwd`), `gs.bin`, then the
    gather's and the raster's. `gs.exchange` counts `sent_rows` (the
    (gaussian, strip) entries packed, before the caps), `send_slots` (the
    send buffer's rows), `pack_overflow` and `exchange_bytes`."""
    ts = cfg.tile_size
    n_strips = len(bounds) - 1
    d = mesh.axis_index(axis_name)
    row0, rows = bounds[d], bounds[d + 1] - bounds[d]

    with span("gs.project"):
        proj = project_gaussians(
            model.means, model.quats, model.log_scales, model.logit_opacities,
            model.sh, camera, cfg, sh_degree=sh_degree, alive=model.alive,
        )
        if mean2d_offset is not None:
            proj = dataclasses.replace(proj, mean2d=proj.mean2d + mean2d_offset)
        payload = make_payload(proj)                    # (n_local, 16)
    n_local = payload.shape[0]
    with span("gs.pack"):
        send, pack_overflow, sent_rows = pack_by_strip(
            payload, [b * ts for b in bounds], send_cap,
            expand_cap=2 * n_local)
    group = mesh.group(axis_name)
    with span("gs.exchange"):
        count("sent_rows", sent_rows)
        count("send_slots", n_strips * send_cap)
        count("pack_overflow", pack_overflow)
        count("exchange_bytes", off_card_bytes(send, group))
        # (n_strips, K, 16): row block s goes to strip s's owner.
        recv = AllToAll.apply(send, group, "gs.exchange.bwd")
    flat = recv.reshape(n_strips * send_cap, PAYLOAD_DIM)
    with span("gs.bin"):
        binning = bin_gaussians(
            payload_to_projected(flat), camera.width, camera.height, cfg,
            tile_row0=row0, tile_rows=rows,
            capacity=arrival_pair_capacity(cfg, n_strips, send_cap), impl=impl,
        )
        count("pairs", binning.num_pairs)
        count("pair_slots", binning.sorted_ranks.shape[0])
    out = rasterize_payload(
        flat, binning, background, camera.width, camera.height, cfg, impl,
        tile_row0=row0, tile_rows=rows,
    )
    aux = dict(
        radii=proj.radius,
        overflow=binning.overflow + pack_overflow,
        # Exchange drops (send_cap too small: payload lost anywhere in the
        # frustum) apart from strip-binning drops (the pair budget).
        pack_overflow=pack_overflow,
        bin_overflow=binning.overflow,
        num_pairs=binning.num_pairs,
        max_chunks_needed=out.max_chunks_needed,
    )
    return out.image, out.transmittance, aux


def make_gauss_sharded_render(
    mesh: Mesh,
    cfg: RasterConfig,
    width: int,
    height: int,
    sh_degree: int,
    send_cap: Optional[int] = None,
    impl: Optional[str] = None,
    send_fraction: float = 0.5,
    check_overflow: bool = False,
):
    """Build `f(model, camera, background, mean2d_offset=None,
    with_aux=False) -> (image, trans[, aux])` over a model sharded on the
    mesh's gauss axis (`shard_model`). Every rank gets the whole (height,
    width) frame (the strips gathered over the gauss group); a loss that
    every rank computes alike on it back-propagates into each rank's own
    shard. Rank d of the gauss axis rasterizes the tile rows [bounds[d],
    bounds[d + 1]) of `render.strip_bounds`: the first strips are one tile
    row longer where the rows do not divide evenly. The call is the span
    `gs.render` (utils/logging.py), with the spans of
    `render_gauss_sharded_strip` and `gs.strips` under it.

    aux: `radii` (local), and over the gauss group the summed `overflow`,
    `pack_overflow` and `bin_overflow` and the largest `max_chunks_needed`.

    Exchange sizing: with `send_cap` None it comes from the closed-form
    plan (`capacity.plan_gauss_sharded`) at `send_fraction`, the assumed
    bound on the share of one rank's gaussians that land in a single
    strip. A scene that puts more of a shard into one strip loses the
    excess: pass a larger `send_fraction` or `send_cap`, watch
    `aux["pack_overflow"]`, or set `check_overflow` to print a warning on
    stderr whenever the exchange dropped payload rows."""
    nd = mesh.axis_size(GAUSS_AXIS)
    bounds = check_strips(cfg, height, nd, GAUSS_AXIS)
    px = [b * cfg.tile_size for b in bounds]
    group = mesh.group(GAUSS_AXIS)

    def resolve_send_cap(global_capacity: int) -> int:
        if send_cap is not None:
            return send_cap
        return plan_gauss_sharded(
            global_capacity, nd, width, height, sh_degree, cfg,
            send_fraction=send_fraction,
        ).send_cap

    def f(model, camera, background, mean2d_offset=None, with_aux=False):
        with span("gs.render", model.device):
            return _render(model, camera, background, mean2d_offset, with_aux)

    def _render(model, camera, background, mean2d_offset, with_aux):
        if camera.device != model.device:
            camera = camera.to(model.device)
        index = mesh.axis_index(GAUSS_AXIS)
        img, trans, aux = render_gauss_sharded_strip(
            model, camera, cfg, sh_degree, background, bounds,
            resolve_send_cap(model.capacity * nd), mesh,
            mean2d_offset=mean2d_offset,
            impl=resolve_shard_impl(impl if impl is not None else cfg.impl,
                                    model.device),
        )
        img = _GatherStrips.apply(img, group, index, px)[:height]
        trans = _GatherStrips.apply(trans, group, index, px)[:height]
        if not (with_aux or check_overflow):
            return img, trans
        sums = all_reduce(torch.stack([aux["overflow"], aux["pack_overflow"],
                                       aux["bin_overflow"]]).to(torch.int64),
                          "sum", group)
        if check_overflow:
            _warn_on_overflow(int(sums[1]))
        if not with_aux:
            return img, trans
        out = dict(radii=aux["radii"], overflow=sums[0].to(I32),
                   pack_overflow=sums[1].to(I32), bin_overflow=sums[2].to(I32),
                   max_chunks_needed=all_reduce(aux["max_chunks_needed"],
                                                "max", group))
        return img, trans, out

    f.resolve_send_cap = resolve_send_cap
    return f
