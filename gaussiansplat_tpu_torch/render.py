"""Top-level render API: `render(model, camera)`.

  project_gaussians   (ops/projection.py, autograd)
  bin_gaussians       (ops/binning.py: compaction sort, the K4 expansion
                       kernel, pair sort, segments)
  payload gather      (sorted by (tile, depth); backward: the K3 segment
                       reduce, ops/binning.reduce_pair_grads)
  rasterize           (the K1 forward kernel; backward: the K2 kernel)

Each stage is a span (utils/logging.py) of the call's `gs.render`:
`gs.project` (twice: the projection, then the payload), `gs.bin`
(counters `pairs` and `pair_slots`, the pairs binned and the slots the
gather and the pair sort run over), `gs.gather`, `gs.raster`.

It runs on the device of the model's tensors and is differentiable w.r.t.
every model parameter, `background` and `mean2d_offset`: on CUDA tensors
through the kernels, on CPU tensors through their plain versions. Serving
calls it under `torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import RasterConfig
from .models.gaussians import GaussianModel
from .ops.binning import resolve_impl, bin_gaussians
from .ops.camera import Camera
from .ops.projection import make_payload, project_gaussians
from .ops.raster_dispatch import rasterize_payload
from .utils.logging import count, span


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor              # (H, W, 3)
    transmittance: torch.Tensor      # (H, W)
    radii: torch.Tensor              # (N,) int32 screen-space radius (0 = culled)
    num_pairs: torch.Tensor          # () int32 tile/gaussian pairs binned
    overflow: torch.Tensor           # () int32 pairs dropped (capacity exceeded)
    max_chunks_needed: torch.Tensor  # () int32 longest tile list, in chunks


def render(
    model: GaussianModel,
    camera: Camera,
    cfg: Optional[RasterConfig] = None,
    sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> RenderOutput:
    """Render a camera view of the model. `impl` ('auto', 'cuda', 'torch')
    defaults to `cfg.impl`; see ops/raster_dispatch.py. `mean2d_offset`
    (C, 2) is added to the projected centres before binning: pass zeros
    that require grad to harvest each gaussian's screen-space position
    gradient (densification statistics)."""
    cfg = cfg or RasterConfig()
    device = model.device
    with span("gs.render", device):
        if sh_degree is None:
            sh_degree = model.sh_degree
        if background is None:
            background = torch.zeros((3,), dtype=torch.float32, device=device)
        if camera.device != device:
            camera = camera.to(device)
        impl = resolve_impl(impl if impl is not None else cfg.impl, device)

        with span("gs.project"):
            proj = project_gaussians(
                model.means, model.quats, model.log_scales,
                model.logit_opacities, model.sh, camera, cfg,
                sh_degree=sh_degree, alive=model.alive,
            )
            if mean2d_offset is not None:
                proj = dataclasses.replace(proj,
                                           mean2d=proj.mean2d + mean2d_offset)
        with span("gs.bin"):
            binning = bin_gaussians(proj, camera.width, camera.height, cfg,
                                    impl=impl)
            count("pairs", binning.num_pairs)
            count("pair_slots", binning.sorted_ranks.shape[0])
        # The payload is the projection's too, made after the binning so
        # that it is not held through the binning's peak of memory.
        with span("gs.project"):
            payload = make_payload(proj)
        out = rasterize_payload(payload, binning, background, camera.width,
                                camera.height, cfg, impl)
    return RenderOutput(
        image=out.image,
        transmittance=out.transmittance,
        radii=proj.radius,
        num_pairs=binning.num_pairs,
        overflow=binning.overflow,
        max_chunks_needed=out.max_chunks_needed,
    )
