#!/usr/bin/env python3
"""Compare two builds of the forward raster kernel (K1) bit for bit.

    git archive <commit> gaussiansplat_tpu_torch/csrc | tar -x -C other/
    python3 compare_forward_builds.py other/gaussiansplat_tpu_torch/csrc

Builds `forward.cu` of the given csrc directory beside the checkout's own
(one nvcc each, in parallel), runs both through `rasterize_forward_cuda` on
the 1920x1080 benchmark scene of chip_smoke.py at 1M and 300k gaussians,
and prints whether the two (T, 8, tile_px) output blocks are equal in every
bit. Exits non-zero if they differ or no CUDA card is present. The two
sources must export the same `gs_rasterize_forward` launcher.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

import chip_smoke as cs


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_forward_builds: needs a CUDA card", file=sys.stderr)
        return 2
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.kernels import forward
    from gaussiansplat_tpu_torch.ops.kernels.build import CudaKernel, build_all
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    ours = forward.FORWARD
    other = CudaKernel(str(Path(argv[0]).resolve() / "forward.cu"),
                       ours.symbol, ours.argtypes)
    build_all([ours, other])

    def run(kernel, args):
        # The wrapper launches the module's FORWARD; point it at `kernel`
        # for this call, so both builds get the wrapper's own arguments.
        forward.FORWARD = kernel
        try:
            return forward.rasterize_forward_cuda(*args)
        finally:
            forward.FORWARD = ours

    device = torch.device("cuda")
    cfg = RasterConfig()
    cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=cs.FX,
                  fy=cs.FX, width=cs.WIDTH, height=cs.HEIGHT, device=device)
    same_all = True
    for n in (1_000_000, 300_000):
        model = cs.bench_scene(n, device)
        with torch.no_grad():
            proj = cs.project(model, cam, cfg)
            b = bin_gaussians(proj, cs.WIDTH, cs.HEIGHT, cfg, impl="cuda")
            sp = b.gather_payload(make_payload(proj))
            args = (sp, b.tile_starts, cs.WIDTH, cs.HEIGHT, cfg)
            a, o = run(ours, args), run(other, args)
        torch.cuda.synchronize()
        same = torch.equal(a.view(torch.int32), o.view(torch.int32))
        same_all &= same
        print(f"K1 {cs.WIDTH}x{cs.HEIGHT} n={n} ({int(b.num_pairs)} pairs): "
              f"this checkout's build vs {argv[0]}: bit-identical {same}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
