"""2D gaussian splats: screen-space gaussians with an angle rotation each.

The second model family. `project_splats2d` produces the same `Projected`
as the 3D projection, so binning (K4), the payload gather (backward K3) and
the rasterizer (K1, backward K2) are the 3D path's, through the same
`torch.autograd.Function`s. Covariance: W = R(theta) diag(exp(s)),
Sigma = W W^T + dilation I.

Every depth is 0, so the pairs of a tile are composited in the order of the
compaction sort, which is stable: by slot index.

Entry points put the tensors on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import RasterConfig
from ..ops.projection import Projected
from ..ops.raster_dispatch import RenderOutput, rasterize_projected
from ..utils.logging import span

PARAM_NAMES_2D = ("means2d", "log_scales", "thetas", "logit_opacities", "colors")


class Splat2DModel(nn.Module):
    """Fixed-capacity 2D splats, in pixels:
      means2d         (C, 2)  pixel positions
      log_scales      (C, 2)  log standard deviations in pixels
      thetas          (C,)    rotation angles (radians)
      logit_opacities (C,)    pre-sigmoid opacity
      colors          (C, 3)  direct RGB (no SH)
    plus the boolean buffer `alive` (C,)."""

    def __init__(self, means2d, log_scales, thetas, logit_opacities, colors,
                 alive):
        super().__init__()
        self.means2d = nn.Parameter(means2d)
        self.log_scales = nn.Parameter(log_scales)
        self.thetas = nn.Parameter(thetas)
        self.logit_opacities = nn.Parameter(logit_opacities)
        self.colors = nn.Parameter(colors)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means2d.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means2d.device

    @property
    def num_alive(self) -> torch.Tensor:
        """() int32 number of alive slots (stays on the device)."""
        return self.alive.sum(dtype=torch.int32)

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The optimizer-visible parameter groups (alive mask excluded)."""
        return {k: getattr(self, k) for k in PARAM_NAMES_2D}


def random_splats2d(
    generator: torch.Generator,
    n: int,
    width: int,
    height: int,
    capacity: Optional[int] = None,
    scale_range: Tuple[float, float] = (2.0, 10.0),
    opacity: float = 0.7,
    device="cuda",
) -> Splat2DModel:
    """Random screen-space splats: centres uniform over the frame, log
    scales uniform in log(scale_range), angles uniform in [0, pi), colours
    uniform in [0.05, 0.95]. Draws on the generator's device, then moves the
    tensors to `device`. Dead slots past n have tiny scales and opacity."""
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    means = torch.rand((n, 2), **kw) * torch.tensor(
        [float(width), float(height)], device=generator.device)
    lo, hi = math.log(scale_range[0]), math.log(scale_range[1])
    log_scales = lo + torch.rand((n, 2), **kw) * (hi - lo)
    thetas = torch.rand((n,), **kw) * math.pi
    colors = 0.05 + torch.rand((n, 3), **kw) * 0.9
    logit_op = torch.full((n,), math.log(opacity / (1 - opacity)),
                          dtype=torch.float32, device=generator.device)

    def pad(a, fill=0.0):
        rest = torch.full((capacity - n,) + tuple(a.shape[1:]), fill,
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, rest]).to(device)

    return Splat2DModel(
        means2d=pad(means), log_scales=pad(log_scales, -10.0),
        thetas=pad(thetas), logit_opacities=pad(logit_op, -10.0),
        colors=pad(colors),
        alive=(torch.arange(capacity) < n).to(device),
    )


def splats2d_from_numpy(params: Dict[str, np.ndarray], alive: np.ndarray,
                        device="cuda") -> Splat2DModel:
    """A model holding exactly the given parameter arrays and alive mask,
    e.g. a reference-package model's `trainable()` and `alive` passed
    through `np.asarray` (dead slots included)."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32, copy=True)).to(device)
    return Splat2DModel(
        **{k: t(params[k]) for k in PARAM_NAMES_2D},
        alive=torch.as_tensor(np.array(alive, bool, copy=True)).to(device),
    )


def project_splats2d(model: Splat2DModel, cfg: RasterConfig, width: int,
                     height: int) -> Projected:
    """Screen-space covariance -> conic, bounding radius and the exact
    per-axis opacity-aware binning extents. Differentiable by autograd; the
    integer and boolean fields carry no gradient."""
    f32 = torch.float32
    theta = model.thetas.to(f32)
    sx = torch.exp(model.log_scales[:, 0])
    sy = torch.exp(model.log_scales[:, 1])
    ct, st = torch.cos(theta), torch.sin(theta)
    a = (ct * sx) ** 2 + (st * sy) ** 2 + cfg.cov2d_dilation
    b = ct * st * (sx * sx - sy * sy)
    c = (st * sx) ** 2 + (ct * sy) ** 2 + cfg.cov2d_dilation

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
        radius_f = torch.ceil(cfg.sigma_radius * torch.sqrt(mid + disc))

    opacity = torch.sigmoid(model.logit_opacities.to(f32))
    with torch.no_grad():
        # Alpha = op exp(-q/2) >= alpha_min bounds the support by q <=
        # 2 ln(op / alpha_min): the extents use min(sigma_radius, that)
        # sigmas along each axis (with a small slack).
        tau_op = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))
                        - float(math.log(cfg.alpha_min)))
        s_eff = torch.clamp(
            torch.sqrt(torch.clamp(tau_op, min=0.0)) * 1.001 + 1e-2,
            max=cfg.sigma_radius)
        rx_f = torch.ceil(s_eff * torch.sqrt(torch.clamp(a, min=0.0)))
        ry_f = torch.ceil(s_eff * torch.sqrt(torch.clamp(c, min=0.0)))

        u, v = model.means2d[:, 0], model.means2d[:, 1]
        on_screen = ((u + rx_f > 0.0) & (u - rx_f < width)
                     & (v + ry_f > 0.0) & (v - ry_f < height))
        valid = det_ok & on_screen & model.alive & (opacity > cfg.alpha_min)
        zero = torch.zeros_like(radius_f)
        radius = torch.where(valid, radius_f, zero).to(torch.int32)
        radius_xy = torch.stack([torch.where(valid, rx_f, zero),
                                 torch.where(valid, ry_f, zero)],
                                dim=-1).to(torch.int32)

    return Projected(
        mean2d=model.means2d.to(f32),
        depth=torch.zeros_like(model.thetas, dtype=f32).detach(),
        conic=conic,
        rgb=model.colors.to(f32),
        opacity=opacity,
        radius=radius,
        radius_xy=radius_xy,
        valid=valid,
    )


def render_splats2d(
    model: Splat2DModel,
    width: int,
    height: int,
    cfg: Optional[RasterConfig] = None,
    background: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Differentiable screen-space render of the model on the backend
    `cfg.impl`: a `RenderOutput`. Spans as `render()`'s."""
    cfg = cfg or RasterConfig()
    device = model.device
    with span("gs.render", device):
        if background is None:
            background = torch.zeros((3,), dtype=torch.float32, device=device)
        with span("gs.project"):
            proj = project_splats2d(model, cfg, width, height)
        out, binning = rasterize_projected(proj, width, height, cfg,
                                           background)
    return RenderOutput.of(out, binning, proj.radius)
