"""Plain PyTorch reference of 3D Gaussian Splatting: projection, tiled
compositing with its counts, and the gradients of both.

Written from the published description (Kerbl et al., SIGGRAPH 2023; EWA
splatting, Zwicker et al. 2001) and the semantics the program's
`RasterConfig` states, not from the program's code; it imports nothing of
the program. In float32 with TF32 off (`fp32_math`).

- Projection: x_cam = R x + t; pixel u = fx x/z + cx, v = fy y/z + cy;
  Sigma = R_q S S^T R_q^T; the 2D covariance J W Sigma W^T J^T with the
  perspective Jacobian's x/z, y/z clamped to 1.3 tan(fov / 2), plus
  `cov2d_dilation` on the diagonal; the conic is its inverse; colour from
  real SH of the direction camera -> gaussian, +0.5, clamped at 0;
  opacity sigmoid(logit). A gaussian is valid when alive, near < z < far
  and the 2D covariance is positive definite.
- Compositing of pixel (x, y) (integer coordinates): front to back by
  camera depth (ties by index), alpha = opacity exp(-q/2) with q the conic
  form of the offset, zero unless alpha >= alpha_min and q <= sigma^2,
  clamped at alpha_max; the colour sum of alpha T, T the product of
  (1 - alpha) in front; image = colour + T background.
- Early exit: a tile of tile_size^2 pixels stops after the first pair at
  which every pixel of the tile has T <= trans_eps (pairs after it add
  nothing to any of its pixels). The program checks at the end of chunks
  of chunk_size pairs, so it composites up to chunk_size - 1 pairs more,
  each at T <= trans_eps.

A gaussian is binned to every tile its support box (the bounding box of
q <= min(sigma^2, 2 ln(op / alpha_min)), widened by a pixel) meets; a tile
is evaluated over its pairs, padded, in blocks of tiles of similar length.
The backward recomputes each block under autograd and sums the pairs'
gradients into the gaussians, then runs autograd through the projection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch

F32 = torch.float32

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# Elements of one (tiles, pairs, pixels) temporary of a block: 512 MB in
# the forward, 256 MB in the backward, which keeps more of them. Blocks of
# several tiles keep the launches few.
FORWARD_ELEMS = 1 << 27
BACKWARD_ELEMS = 1 << 26

# The raster fields of a gaussian, in this order: centre u, v; conic ca,
# cb, cc; opacity; colour r, g, b.
FIELDS = ("u", "v", "ca", "cb", "cc", "op", "r", "g", "b")


@contextlib.contextmanager
def fp32_math():
    """float32 matrix products and convolutions without TF32, restored on
    exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass
class Camera:
    R: torch.Tensor     # (3, 3) float32 world-to-camera rotation
    t: torch.Tensor     # (3,) float32
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclasses.dataclass
class Raster:
    """The `RasterConfig` values the reference follows."""

    tile_size: int
    alpha_min: float
    alpha_max: float
    trans_eps: float
    sigma_radius: float
    cov2d_dilation: float
    near: float
    far: float

    @classmethod
    def from_dict(cls, d: dict) -> "Raster":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class RasterCounts:
    """Raster work of one frame (see reference/counts.py)."""

    pairs: int = 0
    inside: int = 0
    live: int = 0

    def add(self, other: "RasterCounts") -> None:
        self.pairs += other.pairs
        self.inside += other.inside
        self.live += other.live


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of unit directions (N, 3) -> (N, (degree + 1)^2)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                SH_C2[4] * (xx - yy)]
    if degree >= 3:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions, normalized here -> (N, 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def project(params: Dict[str, torch.Tensor], alive: torch.Tensor,
            cam: Camera, rc: Raster, sh_degree: int) -> dict:
    """Screen-space gaussians. Differentiable w.r.t. `params` in the
    float fields; returns `fields` (N, 9) in FIELDS order, the 2D
    covariance diagonal `cov_xx`, `cov_yy`, `depth` and `valid`."""
    means = params["means"]
    p = means @ cam.R.T + cam.t
    x, y, z = p.unbind(-1)
    in_front = (z > rc.near) & (z < rc.far)
    zs = torch.where(in_front, z, torch.ones_like(z))
    u = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy

    m = quat_rotmat(params["quats"]) * torch.exp(params["log_scales"])[:, None, :]
    sigma = m @ m.transpose(1, 2)
    lim_x = 1.3 * 0.5 * cam.width / cam.fx
    lim_y = 1.3 * 0.5 * cam.height / cam.fy
    tx = torch.clamp(x / zs, -lim_x, lim_x)
    ty = torch.clamp(y / zs, -lim_y, lim_y)
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * tx / zs], dim=-1),
        torch.stack([zero, cam.fy / zs, -cam.fy * ty / zs], dim=-1),
    ], dim=-2)                                            # (N, 2, 3)
    tw = jac @ cam.R
    cov = tw @ sigma @ tw.transpose(1, 2)
    a = cov[:, 0, 0] + rc.cov2d_dilation
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + rc.cov2d_dilation
    det = a * c - b * b
    det_ok = det > 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))

    k = (sh_degree + 1) ** 2
    sh = torch.cat([params["sh_dc"], params["sh_rest"]], dim=1)[:, :3 * k]
    campos = -cam.R.T @ cam.t
    d = means - campos
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    basis = sh_basis(d, sh_degree)
    rgb = (basis[:, :, None] * sh.reshape(-1, k, 3)).sum(1) + 0.5
    rgb = torch.clamp(rgb, min=0.0)
    op = torch.sigmoid(params["logit_opacities"])
    fields = torch.stack([u, v, c / det_s, -b / det_s, a / det_s, op,
                          rgb[:, 0], rgb[:, 1], rgb[:, 2]], dim=-1)
    return dict(fields=fields, cov_xx=a.detach(), cov_yy=c.detach(),
                depth=z.detach(), valid=alive & in_front & det_ok)


@dataclasses.dataclass
class Binning:
    """Pairs sorted by (tile, depth, index)."""

    gauss: torch.Tensor       # (P,) int64 gaussian of each pair
    tile_start: torch.Tensor  # (T + 1,) int64
    tiles_x: int
    tiles_y: int
    hx: torch.Tensor          # (N,) support box half-widths (px)
    hy: torch.Tensor


def bin_pairs(proj: dict, cam: Camera, rc: Raster) -> Binning:
    fields = proj["fields"].detach()
    u, v, op = fields[:, 0], fields[:, 1], fields[:, 5]
    ts = rc.tile_size
    tiles_x = -(-cam.width // ts)
    tiles_y = -(-cam.height // ts)
    r2 = torch.clamp(torch.minimum(
        torch.full_like(op, rc.sigma_radius ** 2),
        2.0 * torch.log(torch.clamp(op, min=1e-30) / rc.alpha_min)), min=0.0)
    hx = torch.sqrt(r2 * proj["cov_xx"])
    hy = torch.sqrt(r2 * proj["cov_yy"])
    valid = proj["valid"] & (r2 > 0)
    # Pixels are integer coordinates; a one-pixel margin on the box.
    x0 = torch.floor((u - hx - 1) / ts).clamp(0, tiles_x - 1)
    x1 = torch.floor((u + hx + 1) / ts).clamp(0, tiles_x - 1)
    y0 = torch.floor((v - hy - 1) / ts).clamp(0, tiles_y - 1)
    y1 = torch.floor((v + hy + 1) / ts).clamp(0, tiles_y - 1)
    on = (valid & (u + hx + 1 >= 0) & (u - hx - 1 <= cam.width - 1)
          & (v + hy + 1 >= 0) & (v - hy - 1 <= cam.height - 1))
    w = (x1 - x0 + 1).long()
    h = (y1 - y0 + 1).long()
    cnt = torch.where(on, w * h, torch.zeros_like(w))
    n = fields.shape[0]
    depth = torch.where(valid, proj["depth"], torch.full_like(u, math.inf))
    order = torch.sort(depth, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=u.device)

    idx = torch.nonzero(cnt).squeeze(1)
    c = cnt[idx]
    g = torch.repeat_interleave(idx, c)
    first = torch.cumsum(c, 0) - c
    j = torch.arange(g.numel(), device=u.device) - torch.repeat_interleave(first, c)
    wg = w[g]
    tile = ((y0[g].long() + j // wg) * tiles_x + x0[g].long() + j % wg)
    key = tile * n + rank[g]
    key, perm = torch.sort(key)
    g = g[perm]
    tile = key // n
    starts = torch.searchsorted(tile, torch.arange(
        tiles_x * tiles_y + 1, device=u.device))
    return Binning(gauss=g, tile_start=starts, tiles_x=tiles_x,
                   tiles_y=tiles_y, hx=hx, hy=hy)


def _blocks(b: Binning, elems: int, px: int):
    """Tiles with pairs in blocks of similar length: (tiles, length) with
    tiles x length x px at most `elems` (a longer tile goes alone)."""
    lens = (b.tile_start[1:] - b.tile_start[:-1]).cpu()
    order = torch.argsort(lens, descending=True).tolist()
    lens = lens.tolist()
    i = 0
    while i < len(order) and lens[order[i]] > 0:
        top = lens[order[i]]
        n = max(1, elems // (top * px))
        block = [t for t in order[i:i + n] if lens[t] > 0]
        yield block, top
        i += len(block)


def _block(fields, b: Binning, tiles, length, cam: Camera, rc: Raster,
           count: bool = False):
    """Composite one block of tiles. `fields` (N, 9). Returns (colour (B,
    px, 3), T (B, px), the gathered rows (B, L, 9), pair mask (B, L) and
    gaussian ids (B, L), counts or None)."""
    dev = fields.device
    ts = rc.tile_size
    tiles_t = torch.tensor(tiles, device=dev)
    start = b.tile_start[tiles_t]
    n_pairs = b.tile_start[tiles_t + 1] - start
    ar = torch.arange(length, device=dev)
    mask = ar[None, :] < n_pairs[:, None]
    pos = torch.where(mask, start[:, None] + ar[None, :],
                      torch.zeros_like(start[:, None]))
    gid = b.gauss[pos]
    rows = fields[gid]                                     # (B, L, 9)
    pix = torch.arange(ts * ts, device=dev)
    gx = ((tiles_t % b.tiles_x) * ts)[:, None] + pix % ts   # (B, px)
    gy = ((tiles_t // b.tiles_x) * ts)[:, None] + pix // ts
    dx = gx[:, None, :].to(F32) - rows[..., 0:1]            # (B, L, px)
    dy = gy[:, None, :].to(F32) - rows[..., 1:2]
    q = (rows[..., 2:3] * dx * dx + 2.0 * rows[..., 3:4] * dx * dy
         + rows[..., 4:5] * dy * dy)
    a_raw = rows[..., 5:6] * torch.exp(-0.5 * q)
    live = ((a_raw >= rc.alpha_min) & (q <= rc.sigma_radius ** 2)
            & mask[..., None])
    alpha = torch.where(live, torch.clamp(a_raw, max=rc.alpha_max),
                        torch.zeros_like(a_raw))
    ell = torch.log1p(-alpha)
    s_incl = torch.cumsum(ell, dim=1)
    with torch.no_grad():
        if rc.trans_eps > 0:
            sat = s_incl.amax(dim=2) <= math.log(rc.trans_eps)   # (B, L)
            stop = torch.where(sat.any(1), sat.to(torch.int8).argmax(1),
                               torch.full_like(n_pairs, length - 1))
            keep = ar[None, :] <= stop[:, None]
        else:
            keep = torch.ones_like(mask)
    keep_f = keep[..., None].to(F32)
    w = alpha * keep_f * torch.exp(s_incl - ell)
    colour = torch.bmm(w.transpose(1, 2), rows[..., 6:9])   # (B, px, 3)
    trans = torch.exp((ell * keep_f).sum(1))
    counts = None
    if count:
        with torch.no_grad():
            in_img = ((gx < cam.width) & (gy < cam.height))[:, None, :]
            hx = b.hx[gid][..., None]
            hy = b.hy[gid][..., None]
            use = (keep & mask)[..., None] & in_img
            inside = (dx.abs() <= hx) & (dy.abs() <= hy) & use
            counts = RasterCounts(pairs=int(inside.any(2).sum()),
                                  inside=int(inside.sum()),
                                  live=int((live & use).sum()))
    return colour, trans, rows, mask, gid, counts


def _assemble(tile_vals, b: Binning, cam: Camera, rc: Raster):
    """(T, px, C) tile values -> (H, W, C) image."""
    ts = rc.tile_size
    c = tile_vals.shape[-1]
    img = tile_vals.reshape(b.tiles_y, b.tiles_x, ts, ts, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(b.tiles_y * ts, b.tiles_x * ts, c)
    return img[:cam.height, :cam.width]


def _to_tiles(img, b: Binning, rc: Raster):
    """(H, W, C) -> (T, px, C), zero-padded."""
    ts = rc.tile_size
    h, w, c = img.shape
    img = torch.nn.functional.pad(img, (0, 0, 0, b.tiles_x * ts - w,
                                        0, b.tiles_y * ts - h))
    t = img.reshape(b.tiles_y, ts, b.tiles_x, ts, c).permute(0, 2, 1, 3, 4)
    return t.reshape(b.tiles_y * b.tiles_x, ts * ts, c)


def round_fields(fields: torch.Tensor, dtype: Optional[torch.dtype]):
    """The raster fields rounded to `dtype` and back (None: unchanged)."""
    return fields if dtype is None else fields.to(dtype).to(F32)


@torch.no_grad()
def render(proj: dict, cam: Camera, rc: Raster, background=None,
           count: bool = False, fields=None):
    """Image (H, W, 3), transmittance (H, W) and, with `count`, the
    RasterCounts. `fields` replaces proj['fields'] (e.g. rounded)."""
    fields = (proj["fields"] if fields is None else fields).detach()
    dev = fields.device
    b = bin_pairs(proj, cam, rc)
    px = rc.tile_size ** 2
    nt = b.tiles_x * b.tiles_y
    col = torch.zeros((nt, px, 3), dtype=F32, device=dev)
    tr = torch.ones((nt, px, 1), dtype=F32, device=dev)
    total = RasterCounts()
    for tiles, length in _blocks(b, FORWARD_ELEMS, px):
        c, t, _, _, _, cnt = _block(fields, b, tiles, length, cam, rc,
                                    count=count)
        idx = torch.tensor(tiles, device=dev)
        col[idx] = c
        tr[idx] = t[..., None]
        if cnt is not None:
            total.add(cnt)
    image = _assemble(col, b, cam, rc)
    trans = _assemble(tr, b, cam, rc)[..., 0]
    if background is not None:
        image = image + trans[..., None] * background
    return image, trans, (total if count else None)


def raster_backward(proj: dict, fields, cam: Camera, rc: Raster,
                    dimage: torch.Tensor, background=None) -> torch.Tensor:
    """Gradient (N, 9) of sum(image * dimage) w.r.t. the raster fields
    (detached), block by block."""
    fields = fields.detach()
    dev = fields.device
    b = bin_pairs(proj, cam, rc)
    px = rc.tile_size ** 2
    dcol = _to_tiles(dimage, b, rc)                          # (T, px, 3)
    dtr = None
    if background is not None:
        dtr = (dcol * background).sum(-1)                    # (T, px)
    grad = torch.zeros_like(fields)
    for tiles, length in _blocks(b, BACKWARD_ELEMS, px):
        idx = torch.tensor(tiles, device=dev)
        leaf = fields.detach().requires_grad_(True)
        with torch.enable_grad():
            c, t, rows, mask, gid, _ = _block(leaf, b, tiles, length, cam, rc)
            s = (c * dcol[idx]).sum()
            if dtr is not None:
                s = s + (t * dtr[idx]).sum()
            (g_rows,) = torch.autograd.grad(s, rows)
        grad.index_add_(0, gid[mask], g_rows[mask])
    return grad
