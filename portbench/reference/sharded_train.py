"""The plain reference's training steps (reference/train.py) for a scene
too large to follow on one card in one piece, with the first gradient's
rows kept for a comparison row by row.

The same steps as `train.follow` (the loss, the gradients through
reference/render.py's projection, binning and compositing, Adam with the
3DGS learning rates), computed in pieces that fit:

- each block of tiles is composited front to back PAIR_CHUNK pairs at a
  time, and a tile leaves it once it has exited early (render.py
  composites a tile's whole list and masks the pairs past the exit: at
  32M gaussians and opacity 0.8 most of a tile's pairs lie past it);

- the tile blocks of the forward and of the raster backward are dealt
  round-robin over the ranks of a torch.distributed group (each rank
  composites every world-th block); the tiles and the raster fields'
  gradients are summed over the group by `all_reduce`, so every rank
  holds the whole image and every gaussian's gradient (without a group,
  one process takes every block);
- the projection runs without autograd for the raster, and its backward
  recomputes it under autograd, both in chunks of CHUNK gaussians, each
  of which projects on its own (the projection has no term across
  gaussians).

Every rank then holds the same reference state. It imports nothing of
the program; float32 with TF32 off (`render.fp32_math`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import render as R
from .train import LEAVES, loss_fn, position_lr

# Gaussians a chunk of the projection projects at a time.
CHUNK = 1 << 22
# Pairs of each tile of a block that one step of the compositing takes.
PAIR_CHUNK = 1024


def _world(group) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def _tile_blocks(lens: torch.Tensor, elems: int, px: int, whole: bool):
    """The tiles of `lens` (pairs a tile, on the host) that have any,
    longest first, in blocks: (tiles, the block's longest). A block is as
    many tiles as fit `elems` elements in one (tiles, pairs, pixels)
    temporary of PAIR_CHUNK pairs, or, with `whole` (autograd keeps every
    step's), of the block's longest, rounded up to whole steps."""
    order = [t for t in torch.argsort(lens, descending=True).tolist()
             if lens[t] > 0]
    i = 0
    while i < len(order):
        top = int(lens[order[i]])
        size = -(-top // PAIR_CHUNK) * PAIR_CHUNK if whole else PAIR_CHUNK
        n = max(1, elems // (size * px))
        yield order[i:i + n], top
        i += n


def _composite(fields, b: R.Binning, tiles, length: int, cam: R.Camera,
               rc: R.Raster, count: bool = False):
    """Composite one block of tiles front to back, PAIR_CHUNK pairs of
    each at a time, as `render._block` composites them: alpha, the early
    exit after the first pair at which every pixel of the tile has T <=
    trans_eps, the colour sum of alpha T. A tile leaves the block's steps
    once it has exited or run out of pairs. Returns (colour (B, px, 3), T
    (B, px), the steps [(rows (b, C, 9), gaussian ids, pair mask)], counts
    or None, the pairs each tile composited)."""
    dev = fields.device
    ts = rc.tile_size
    tiles_t = torch.tensor(tiles, device=dev)
    start = b.tile_start[tiles_t]
    n_pairs = b.tile_start[tiles_t + 1] - start
    pix = torch.arange(ts * ts, device=dev)
    gx = ((tiles_t % b.tiles_x) * ts)[:, None] + pix % ts      # (B, px)
    gy = ((tiles_t // b.tiles_x) * ts)[:, None] + pix // ts
    log_t = torch.zeros(gx.shape, dtype=R.F32, device=dev)  # log T so far
    colour = torch.zeros(gx.shape + (3,), dtype=R.F32, device=dev)
    eps = math.log(rc.trans_eps) if rc.trans_eps > 0 else None
    steps, counts = [], (R.RasterCounts() if count else None)
    used = torch.zeros(len(tiles), dtype=torch.int64, device=dev)
    act = torch.arange(len(tiles), device=dev)     # the tiles still going
    for a in range(0, length, PAIR_CHUNK):
        c = min(PAIR_CHUNK, length - a)
        ar = a + torch.arange(c, device=dev)
        mask = ar[None, :] < n_pairs[act, None]
        pos = torch.where(mask, start[act, None] + ar[None, :],
                          torch.zeros_like(mask, dtype=start.dtype))
        gid = b.gauss[pos]
        rows = fields[gid]                                     # (b, C, 9)
        dx = gx[act, None, :].to(R.F32) - rows[..., 0:1]       # (b, C, px)
        dy = gy[act, None, :].to(R.F32) - rows[..., 1:2]
        q = (rows[..., 2:3] * dx * dx + 2.0 * rows[..., 3:4] * dx * dy
             + rows[..., 4:5] * dy * dy)
        a_raw = rows[..., 5:6] * torch.exp(-0.5 * q)
        live = ((a_raw >= rc.alpha_min) & (q <= rc.sigma_radius ** 2)
                & mask[..., None])
        alpha = torch.where(live, torch.clamp(a_raw, max=rc.alpha_max),
                            torch.zeros_like(a_raw))
        ell = torch.log1p(-alpha)
        s_incl = log_t[act, None, :] + torch.cumsum(ell, dim=1)
        with torch.no_grad():
            exits = torch.zeros(act.shape, dtype=torch.bool, device=dev)
            keep = torch.ones_like(mask)
            if eps is not None:
                sat = s_incl.amax(dim=2) <= eps                # (b, C)
                exits = sat.any(1)
                first = torch.where(exits, sat.to(torch.int8).argmax(1),
                                    torch.full_like(act, c))
                keep = torch.arange(c, device=dev)[None, :] <= first[:, None]
        keep_f = keep[..., None].to(R.F32)
        w = alpha * keep_f * torch.exp(s_incl - ell)
        colour = colour.index_add(0, act, torch.bmm(w.transpose(1, 2),
                                                    rows[..., 6:9]))
        log_t = log_t.index_add(0, act, (ell * keep_f).sum(1))
        steps.append((rows, gid, mask))
        used = used.index_add(0, act, (keep & mask).sum(1))
        if count:
            with torch.no_grad():
                in_img = ((gx[act] < cam.width)
                          & (gy[act] < cam.height))[:, None, :]
                use = (keep & mask)[..., None] & in_img
                inside = ((dx.abs() <= b.hx[gid][..., None])
                          & (dy.abs() <= b.hy[gid][..., None]) & use)
                counts.add(R.RasterCounts(pairs=int(inside.any(2).sum()),
                                          inside=int(inside.sum()),
                                          live=int((live & use).sum())))
        act = act[~exits & (n_pairs[act] > a + c)]
        if act.numel() == 0:
            break
    return colour, torch.exp(log_t), steps, counts, used


def render(fields: torch.Tensor, b: R.Binning, cam: R.Camera, rc: R.Raster,
           background, count: bool, group):
    """`render.render` with the tile blocks dealt over `group`: image (H,
    W, 3), with `count` the RasterCounts, and the pairs each tile
    composited (its list up to the early exit), the same on every rank."""
    rank, world = _world(group)
    dev = fields.device
    px = rc.tile_size ** 2
    nt = b.tiles_x * b.tiles_y
    col = torch.zeros((nt, px, 3), dtype=R.F32, device=dev)
    tr = torch.zeros((nt, px, 1), dtype=R.F32, device=dev)
    used = torch.zeros(nt, dtype=torch.int64, device=dev)
    total = torch.zeros(3, dtype=torch.int64, device=dev)
    lens = (b.tile_start[1:] - b.tile_start[:-1]).cpu()
    for j, (tiles, length) in enumerate(
            _tile_blocks(lens, R.FORWARD_ELEMS, px, whole=False)):
        if j % world != rank:
            continue
        c, t, _, cnt, u = _composite(fields, b, tiles, length, cam, rc, count)
        idx = torch.tensor(tiles, device=dev)
        col[idx] = c
        tr[idx] = t[..., None]
        used[idx] = u
        if cnt is not None:
            total += torch.tensor([cnt.pairs, cnt.inside, cnt.live], device=dev)
    # Each tile with pairs is written by one rank; the others stay empty.
    _sum(col, group)
    _sum(tr, group)
    _sum(used, group)
    tr[b.tile_start[1:] == b.tile_start[:-1]] = 1.0
    image = R._assemble(col, b, cam, rc)
    trans = R._assemble(tr, b, cam, rc)[..., 0]
    if background is not None:
        image = image + trans[..., None] * background
    counts = None
    if count:
        pairs, inside, live = _sum(total, group).tolist()
        counts = R.RasterCounts(pairs=pairs, inside=inside, live=live)
    return image, counts, used


def raster_backward(fields: torch.Tensor, b: R.Binning, cam: R.Camera,
                    rc: R.Raster, dimage: torch.Tensor, background, group,
                    used: torch.Tensor) -> torch.Tensor:
    """`render.raster_backward` with the tile blocks dealt over `group`:
    the (N, 9) gradient of the raster fields, summed over the group. The
    blocks are sized by `used`, the pairs each tile composited in the
    forward (`render`), which autograd keeps."""
    rank, world = _world(group)
    fields = fields.detach()
    dev = fields.device
    px = rc.tile_size ** 2
    dcol = R._to_tiles(dimage, b, rc)
    dtr = None if background is None else (dcol * background).sum(-1)
    grad = torch.zeros_like(fields)
    for j, (tiles, length) in enumerate(
            _tile_blocks(used.cpu(), R.BACKWARD_ELEMS, px, whole=True)):
        if j % world != rank:
            continue
        idx = torch.tensor(tiles, device=dev)
        leaf = fields.detach().requires_grad_(True)
        with torch.enable_grad():
            c, t, steps, _, _ = _composite(leaf, b, tiles, length, cam, rc)
            s = (c * dcol[idx]).sum()
            if dtr is not None:
                s = s + (t * dtr[idx]).sum()
            g_rows = torch.autograd.grad(s, [rows for rows, _, _ in steps])
        for (_, gid, mask), g in zip(steps, g_rows):
            grad.index_add_(0, gid[mask], g[mask])
    return _sum(grad, group)


def project(p: Dict[str, torch.Tensor], alive: torch.Tensor, cam: R.Camera,
            rc: R.Raster, sh_degree: int) -> dict:
    """`render.project` CHUNK gaussians at a time (its outputs joined)."""
    parts = [R.project({k: v[a:a + CHUNK] for k, v in p.items()},
                       alive[a:a + CHUNK], cam, rc, sh_degree)
             for a in range(0, alive.shape[0], CHUNK)]
    return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}


def image(params: Dict[str, torch.Tensor], alive: torch.Tensor,
          cam: R.Camera, rc: R.Raster, sh_degree: int,
          background=None) -> torch.Tensor:
    """`render.render`'s image of the scene from `cam`, in one process."""
    with R.fp32_math(), torch.no_grad():
        proj = project(params, alive, cam, rc, sh_degree)
        b = R.bin_pairs(proj, cam, rc)
        return render(proj["fields"], b, cam, rc, background, False, None)[0]


def project_backward(p: Dict[str, torch.Tensor], alive: torch.Tensor,
                     cam: R.Camera, rc: R.Raster, sh_degree: int,
                     dfields: torch.Tensor,
                     payload_dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient from the raster fields' `dfields`, the
    projection recomputed under autograd CHUNK gaussians at a time (through
    the control's rounding of the fields, as `train.follow`)."""
    out = {k: torch.zeros_like(v) for k, v in p.items()}
    n = alive.shape[0]
    for a in range(0, n, CHUNK):
        e = min(n, a + CHUNK)
        leaves = {k: p[k][a:e].detach().requires_grad_(True) for k in LEAVES}
        with torch.enable_grad():
            proj = R.project(leaves, alive[a:e], cam, rc, sh_degree)
            fields = R.round_fields(proj["fields"], payload_dtype)
            grads = torch.autograd.grad(fields, list(leaves.values()),
                                        grad_outputs=dfields[a:e],
                                        allow_unused=True)
        for k, g in zip(leaves, grads):
            if g is not None:
                out[k][a:e] = g
    return out


def follow(params0: Dict[str, torch.Tensor], alive: torch.Tensor, views,
           rc: R.Raster, train: dict, sh_degree: int, extent: float,
           steps: int, payload_dtype: Optional[torch.dtype] = None,
           half_batch: bool = False, count: bool = False, group=None,
           keep: Optional[Tuple[int, int]] = None) -> dict:
    """`train.follow`'s readings (each step's loss, each leaf's first
    gradient's norm and change after the steps, each step's counts), and
    `first_grads`: each leaf's rows [keep[0], keep[1]) (every row for
    None) of the first gradient, on the host. `group`: the ranks the tile
    blocks are dealt over (every rank must call it alike)."""
    p = {k: params0[k].detach().clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = train["beta1"], train["beta2"], train["adam_eps"]
    lrs = dict(quats=train["lr_quats"], log_scales=train["lr_scales"],
               logit_opacities=train["lr_opacities"], sh_dc=train["lr_sh_dc"],
               sh_rest=train["lr_sh_rest"])
    r0, r1 = keep if keep is not None else (0, alive.shape[0])
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    first: Dict[str, torch.Tensor] = {}
    counts = []
    with R.fp32_math(), torch.no_grad():
        for i in range(steps):
            cam, gt, bg = views[i]
            proj = project(p, alive, cam, rc, sh_degree)
            fields = R.round_fields(proj["fields"], payload_dtype)
            b = R.bin_pairs(proj, cam, rc)
            img, cnt, used = render(fields, b, cam, rc, bg, count, group)
            counts.append(cnt)
            rows = img.shape[0] // 2 if half_batch else img.shape[0]
            with torch.enable_grad():
                img.requires_grad_(True)
                loss = loss_fn(img[:rows], gt[:rows], train["ssim_lambda"])
                (dimg,) = torch.autograd.grad(loss, img)
            losses.append(loss.item())
            dfields = raster_backward(fields, b, cam, rc, dimg, bg, group,
                                      used)
            del proj, fields, b, img, dimg
            g = project_backward(p, alive, cam, rc, sh_degree, dfields,
                                 payload_dtype)
            del dfields
            if i == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g[k]))
                              for k in LEAVES}
                first = {k: g[k][r0:r1].cpu() for k in LEAVES}
            t = i + 1
            for k in LEAVES:
                lr = position_lr(train, extent, i) if k == "means" else lrs[k]
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            del g
    change = {k: float(torch.linalg.vector_norm(p[k] - params0[k]))
              for k in LEAVES}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                counts=counts, first_grads=first)


def block_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's ||got - want|| / ||want|| of one block of rows of
    the first gradient (inf when a difference is not finite)."""
    gaps = []
    for k in LEAVES:
        w = want[k].to(torch.float64)
        d = float(torch.linalg.vector_norm(got[k].to(w) - w))
        gaps.append(d / max(float(torch.linalg.vector_norm(w)), 1e-30))
    return math.inf if any(map(math.isnan, gaps)) else max(gaps)
