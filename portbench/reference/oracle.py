"""The dense oracle: every pixel composited over every gaussian, without
tiles and without the early exit. A copy of the port's
ops/oracle.render_oracle_full, on reference/render.py's projection; it
renders the quality cell's ground-truth views.

Image rows go in bands; a band takes only the gaussians whose
q <= sigma_radius^2 ellipse reaches its rows (every other gaussian has
alpha exactly 0 there), and its pixels go in sub-chunks that keep the
(pixels, gaussians) temporaries under MAX_CHUNK_ELEMS.
"""

from __future__ import annotations

import torch

from .render import Camera, Raster, fp32_math

MAX_CHUNK_ELEMS = 1 << 26


def _composite(xs, ys, f, rc: Raster):
    dx = xs[:, None] - f[None, :, 0]
    dy = ys[:, None] - f[None, :, 1]
    q = f[None, :, 2] * dx * dx + 2.0 * f[None, :, 3] * dx * dy \
        + f[None, :, 4] * dy * dy
    alpha = f[None, :, 5] * torch.exp(-0.5 * q)
    off = (alpha < rc.alpha_min) | (q > rc.sigma_radius ** 2)
    alpha = torch.clamp(torch.where(off, torch.zeros_like(alpha), alpha),
                        max=rc.alpha_max)
    ell = torch.log1p(-alpha)
    log_t = torch.cumsum(ell, dim=1)
    w = alpha * torch.exp(log_t - ell)
    return w @ f[:, 6:9], torch.exp(log_t[:, -1])


@torch.no_grad()
def render_dense(proj: dict, cam: Camera, rc: Raster, pixel_chunk: int = 4096):
    """(H, W, 3) image over a black background and (H, W) transmittance."""
    with fp32_math():
        return _render_dense(proj, cam, rc, pixel_chunk)


def _render_dense(proj, cam, rc, pixel_chunk):
    f = proj["fields"].detach()
    dev = f.device
    depth = torch.where(proj["valid"], proj["depth"],
                        torch.full_like(proj["depth"], float("inf")))
    order = torch.argsort(depth, stable=True)
    f = f[order][proj["valid"][order]]
    a, b, c = f[:, 2], f[:, 3], f[:, 4]
    det = a * c - b * b
    sig_yy = torch.where(det > 0, a / det, torch.full_like(det, float("inf")))
    reach = rc.sigma_radius * torch.sqrt(torch.clamp(sig_yy, min=0.0)) * 1.01 + 1.0
    lo, hi = f[:, 1] - reach, f[:, 1] + reach
    h, w = cam.height, cam.width
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1).float(), ys.reshape(-1).float()
    img = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((h * w,), dtype=torch.float32, device=dev)
    rows = max(1, pixel_chunk // w)
    for r0 in range(0, h, rows):
        r1 = min(r0 + rows, h)
        sel = torch.nonzero((hi >= r0) & (lo <= r1 - 1)).squeeze(1)
        if sel.numel() == 0:
            continue
        fb = f[sel]
        step = max(1, MAX_CHUNK_ELEMS // sel.numel())
        for s in range(r0 * w, r1 * w, step):
            e = min(s + step, r1 * w)
            img[s:e], trans[s:e] = _composite(xs[s:e], ys[s:e], fb, rc)
    return img.reshape(h, w, 3), trans.reshape(h, w)
