"""Top-level render API: `render(model, camera)`, and the front half that
every render path of a `GaussianModel` shares (`project_model`).

  project_gaussians   (ops/projection.py, autograd)
  bin_gaussians       (ops/binning.py: compaction sort, the K4 expansion
                       kernel, pair sort, segments)
  payload gather      (sorted by (tile, depth); backward: the K3 segment
                       reduce, ops/binning.reduce_pair_grads)
  rasterize           (the K1 forward kernel; backward: the K2 kernel)

The last three are the back half, `ops/raster_dispatch.rasterize_projected`.
Each stage is a span (utils/logging.py) of the call's `gs.render`:
`gs.project` (twice: the projection, then the payload), `gs.bin`
(counters `pairs` and `pair_slots`, the pairs binned and the slots the
pair sort runs over), `gs.gather`, `gs.raster`.

It runs on the device of the model's tensors and is differentiable w.r.t.
every model parameter, `background` and `mean2d_offset`: on CUDA tensors
through the kernels, on CPU tensors through their plain versions
(`RasterConfig.impl`). Serving calls it under `torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import RasterConfig
from .models.gaussians import GaussianModel
from .ops.camera import Camera
from .ops.projection import Projected, project_gaussians
from .ops.raster_dispatch import RenderOutput, rasterize_projected
from .utils.logging import span

__all__ = ["RenderOutput", "project_model", "render"]


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


def render(
    model: GaussianModel,
    camera: Camera,
    cfg: Optional[RasterConfig] = None,
    sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render a camera view of the model on the backend `cfg.impl`
    (`project_model` for `mean2d_offset`)."""
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
            proj = project_model(model, camera, cfg, sh_degree, mean2d_offset)
        out, binning = rasterize_projected(proj, camera.width, camera.height,
                                           cfg, background)
    return RenderOutput.of(out, binning, proj.radius)
