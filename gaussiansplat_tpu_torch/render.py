"""Top-level render API: `render(model, camera)`, and the front half that
every render path of a `GaussianModel` shares (`project_model`).

  projection          (`project_for_raster`: P, the kernel csrc/project.cu,
                       for calls that need no gradient, writing the payload
                       too; else project_gaussians, ops/projection.py,
                       autograd)
  bin_gaussians       (ops/binning.py: compaction sort, the K4 expansion
                       kernel, pair sort, segments)
  payload gather      (sorted by (tile, depth); backward: the K3 segment
                       reduce, ops/binning.reduce_pair_grads)
  rasterize           (the K1 forward kernel; backward: the K2 kernel)

The last three are the back half, `ops/raster_dispatch.rasterize_projected`.
Each stage is a span (utils/logging.py) of the call's `gs.render`:
`gs.project` (counter `project_kernel`: 1 where P ran; without P a second
`gs.project` makes the payload after the binning), `gs.bin`
(counters `pairs` and `pair_slots`, the pairs binned and the slots the
pair sort runs over), `gs.gather`, `gs.raster`.

It runs on the device of the model's tensors and is differentiable w.r.t.
every model parameter, `background` and `mean2d_offset`: on CUDA tensors
through the kernels, on CPU tensors through their plain versions
(`RasterConfig.impl`). Serving calls it under `torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .config import RasterConfig
from .models.gaussians import GaussianModel
from .ops.binning import resolve_impl
from .ops.camera import Camera
from .ops.kernels.project import project_cuda
from .ops.projection import Projected, payload_to_projected, project_gaussians
from .ops.raster_dispatch import RenderOutput, rasterize_projected
from .utils.logging import count, span

__all__ = ["RenderOutput", "project_for_raster", "project_model", "render"]


def project_model(
    model: GaussianModel,
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Projected:
    """Project the model's gaussians for the camera. `mean2d_offset` (C, 2)
    is added to the projected centres before binning: pass zeros that
    require grad to harvest each gaussian's screen-space position gradient
    (densification statistics)."""
    proj = project_gaussians(
        model.means, model.quats, model.log_scales, model.logit_opacities,
        model.sh, camera, cfg, sh_degree=sh_degree, alive=model.alive,
    )
    if mean2d_offset is not None:
        proj = dataclasses.replace(proj, mean2d=proj.mean2d + mean2d_offset)
    return proj


def project_for_raster(
    model: GaussianModel,
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Tuple[Projected, Optional[torch.Tensor]]:
    """(proj, payload): the projection and, where P made it in the same
    pass, the raster payload whose columns `proj`'s float fields view.
    P runs on the CUDA backend for calls that need no gradient (grad mode
    off, or no parameter requiring grad) and take no `mean2d_offset`;
    every other call is `project_model(...)` and None, and the payload is
    made after the binning. Counts `project_kernel` (1 where P ran)."""
    if (mean2d_offset is None
            and resolve_impl(cfg.impl, model.device) == "cuda"
            and not (torch.is_grad_enabled()
                     and any(p.requires_grad for p in model.parameters()))):
        count("project_kernel", 1)
        payload, radius, radius_xy, valid = project_cuda(
            model.means, model.quats, model.log_scales,
            model.logit_opacities, model.sh_dc, model.sh_rest, model.alive,
            camera, cfg, sh_degree)
        return payload_to_projected(payload, radius, radius_xy, valid), payload
    count("project_kernel", 0)
    return project_model(model, camera, cfg, sh_degree, mean2d_offset), None


def render(
    model: GaussianModel,
    camera: Camera,
    cfg: Optional[RasterConfig] = None,
    sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render a camera view of the model on the backend `cfg.impl`
    (`project_for_raster`: P where no gradient is needed)."""
    cfg = cfg or RasterConfig()
    device = model.device
    with span("gs.render", device):
        if sh_degree is None:
            sh_degree = model.sh_degree
        if background is None:
            background = torch.zeros((3,), dtype=torch.float32, device=device)
        if camera.device != device:
            camera = camera.to(device)
        with span("gs.project"):
            proj, payload = project_for_raster(model, camera, cfg, sh_degree,
                                               mean2d_offset)
        out, binning = rasterize_projected(proj, camera.width, camera.height,
                                           cfg, background, payload=payload)
    return RenderOutput.of(out, binning, proj.radius)
