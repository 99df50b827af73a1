"""Oracle renderers: per-pixel alpha compositing over *all* gaussians.

Deliberately simple O(pixels x N) renderers that share no code with the
tile binning or the raster kernels, used as ground truth: the correctness
oracle of the tiled path and the ground-truth renderer of the bundled
benchmark scene (data/benchmark.py).

Semantics match the tiled rasterizer:
  * front-to-back order by camera depth (invalid gaussians last, alpha 0),
  * alpha = opacity * exp(-0.5 q), zero below `alpha_min` or past
    q > sigma_radius^2, clamped at `alpha_max`,
  * with `respect_tiles` (render_oracle), each gaussian is restricted to
    the pixels of the tiles its bounding rectangle covers, the exact pixel
    set the tiled path composites.

Both evaluate a chunk of pixels against the depth-sorted gaussians as
(pixels, N) tensors: the transmittance in front of each gaussian by one
log-space cumulative sum over depth, the colour by one (pixels, N) @ (N, 3)
product. `render_oracle` is differentiable by autograd; `render_oracle_full`
(forward only) restricts each band of image rows to the gaussians whose
support can reach it, which skips only terms that are exactly zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import RasterConfig
from .binning import tile_grid, tile_ranges
from .projection import Projected

# render_oracle_full keeps each (pixels, gaussians) temporary below this
# many elements (256 MB in float32).
MAX_CHUNK_ELEMS = 1 << 26


def _depth_sorted(proj: Projected):
    """(order, mean2d, conic, rgb, opacity) front to back; invalid
    gaussians sort last with opacity 0."""
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf), stable=True)
    opacity = torch.where(proj.valid[order], proj.opacity[order],
                          torch.zeros_like(proj.opacity[order]))
    return order, proj.mean2d[order], proj.conic[order], proj.rgb[order], opacity


def _composite(xs, ys, mean2d, conic, rgb, opacity, cfg: RasterConfig,
               inside=None):
    """Colour (P, 3) without background and transmittance (P,) of pixel
    centres (xs, ys) (P,) over depth-sorted gaussians. `inside` (P, N)
    bool, if given, zeroes alpha outside it."""
    dx = xs[:, None] - mean2d[None, :, 0]
    dy = ys[:, None] - mean2d[None, :, 1]
    q = (conic[None, :, 0] * dx * dx + 2.0 * conic[None, :, 1] * dx * dy
         + conic[None, :, 2] * dy * dy)
    alpha = opacity[None, :] * torch.exp(-0.5 * q)
    off = (alpha < cfg.alpha_min) | (q > cfg.sigma_radius * cfg.sigma_radius)
    if inside is not None:
        off = off | ~inside
    alpha = torch.clamp(torch.where(off, torch.zeros_like(alpha), alpha),
                        max=cfg.alpha_max)
    ell = torch.log1p(-alpha)
    log_t = torch.cumsum(ell, dim=1)
    w = alpha * torch.exp(log_t - ell)           # alpha * T in front
    return w @ rgb, torch.exp(log_t[:, -1])


def _pixel_centres(height: int, width: int, device):
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def render_oracle(
    proj: Projected,
    width: int,
    height: int,
    cfg: RasterConfig,
    background: Optional[torch.Tensor] = None,
    respect_tiles: bool = True,
    pixel_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the (H, W, 3) image and (H, W) final transmittance,
    differentiable w.r.t. the float fields of `proj` and `background`
    (the tile rectangles are computed from detached centres)."""
    device = proj.mean2d.device
    if background is None:
        background = torch.zeros((3,), dtype=torch.float32, device=device)
    order, mean2d, conic, rgb, opacity = _depth_sorted(proj)
    if respect_tiles:
        tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
        rect = torch.stack(tile_ranges(proj.mean2d.detach(), proj.radius_xy,
                                       cfg.tile_size, tiles_x, tiles_y),
                           dim=-1)[order]
    xs, ys = _pixel_centres(height, width, device)
    cols, trans = [], []
    for s in range(0, height * width, pixel_chunk):
        x, y = xs[s:s + pixel_chunk], ys[s:s + pixel_chunk]
        inside = None
        if respect_tiles:
            tx = (x // cfg.tile_size)[:, None]
            ty = (y // cfg.tile_size)[:, None]
            inside = ((tx >= rect[None, :, 0]) & (tx < rect[None, :, 2])
                      & (ty >= rect[None, :, 1]) & (ty < rect[None, :, 3]))
        c, t = _composite(x.to(torch.float32), y.to(torch.float32), mean2d,
                          conic, rgb, opacity, cfg, inside)
        cols.append(c)
        trans.append(t)
    col, tr = torch.cat(cols), torch.cat(trans)
    img = col + tr[:, None] * background[None, :]
    return img.reshape(height, width, 3), tr.reshape(height, width)


@torch.no_grad()
def render_oracle_full(
    proj: Projected,
    width: int,
    height: int,
    cfg: RasterConfig,
    background: Optional[torch.Tensor] = None,
    pixel_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense oracle without tiles, forward only: (H, W, 3) image and
    (H, W) transmittance.

    Image rows go in bands of max(1, pixel_chunk // width) rows. A band
    takes only the gaussians whose q <= sigma_radius^2 ellipse reaches its
    rows (|dy| <= sigma_radius sqrt(Sigma_yy), Sigma = conic^-1, with a
    margin): every other gaussian has alpha exactly 0 on the band, and a
    zero alpha changes no partial sum of the compositing. Pixels of a band
    go in sub-chunks that keep the (pixels, gaussians) temporaries under
    MAX_CHUNK_ELEMS."""
    device = proj.mean2d.device
    if background is None:
        background = torch.zeros((3,), dtype=torch.float32, device=device)
    _, mean2d, conic, rgb, opacity = _depth_sorted(proj)
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    det = a * c - b * b
    sig_yy = torch.where(det > 0, a / det, torch.full_like(det, float("inf")))
    reach = cfg.sigma_radius * torch.sqrt(torch.clamp(sig_yy, min=0.0)) * 1.01 + 1.0
    lo, hi = mean2d[:, 1] - reach, mean2d[:, 1] + reach
    live = opacity > 0.0
    xs, ys = _pixel_centres(height, width, device)
    xs, ys = xs.to(torch.float32), ys.to(torch.float32)
    img = torch.empty((height * width, 3), dtype=torch.float32, device=device)
    trans = torch.ones((height * width,), dtype=torch.float32, device=device)
    rows = max(1, pixel_chunk // width)
    for r0 in range(0, height, rows):
        r1 = min(r0 + rows, height)
        sel = torch.nonzero(live & (hi >= r0) & (lo <= r1 - 1)).squeeze(1)
        p0, p1 = r0 * width, r1 * width
        if sel.numel() == 0:
            img[p0:p1] = 0.0
            continue
        m, co, col, op = mean2d[sel], conic[sel], rgb[sel], opacity[sel]
        step = max(1, MAX_CHUNK_ELEMS // sel.numel())
        for s in range(p0, p1, step):
            e = min(s + step, p1)
            img[s:e], trans[s:e] = _composite(xs[s:e], ys[s:e], m, co, col,
                                              op, cfg)
    img = img + trans[:, None] * background[None, :]
    return img.reshape(height, width, 3), trans.reshape(height, width)
