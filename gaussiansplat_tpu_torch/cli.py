"""Command-line entry point of the port: `render`.

  python -m gaussiansplat_tpu_torch render --ply scene.ply [--device cuda]

renders a PLY scene from orbit cameras (or an INRIA cameras.json) to PNG
frames. The device defaults to the card; `--device cpu` runs the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import RasterConfig
from .data.cameras import load_cameras_json
from .ops.camera import orbit_camera
from .render import render
from .utils.checkpoint import import_ply


def _save_image(path: str, img: torch.Tensor) -> str:
    """Save an (H, W, 3) image in [0, 1] as 8-bit PNG (or .npy without PIL)."""
    arr = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", arr)
        return path + ".npy"
    Image.fromarray(arr).save(path)
    return path


def cmd_render(args) -> int:
    device = torch.device(args.device)
    model = import_ply(args.ply, device=device)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    bg = torch.full((3,), 1.0 if args.white_background else 0.0,
                    dtype=torch.float32, device=device)
    if args.cameras:
        cams = load_cameras_json(args.cameras, device=device)[: args.frames]
    else:
        cams = [
            orbit_camera(
                2.0 * math.pi * i / args.frames, args.radius,
                height_offset=args.orbit_height, fx=args.fx, fy=args.fx,
                width=args.width, height=args.height, device=device,
            )
            for i in range(args.frames)
        ]
    os.makedirs(args.out, exist_ok=True)
    with torch.inference_mode():
        for i, cam in enumerate(cams):
            out = render(model, cam, cfg, sh_degree=args.sh_degree,
                         background=bg)
            path = _save_image(os.path.join(args.out, f"frame_{i:04d}.png"),
                               out.image)
            print(f"rendered {path} ({cam.width}x{cam.height}, "
                  f"{int(out.num_pairs)} pairs, overflow {int(out.overflow)})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gaussiansplat_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a PLY scene to images")
    pr.add_argument("--ply", required=True)
    pr.add_argument("--out", default="renders")
    pr.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    pr.add_argument("--pairs-per-gaussian", type=float, default=8.0,
                    help="static pair-list capacity as a multiple of N "
                         "(overflow is counted, never reallocated)")
    pr.add_argument("--sh-degree", type=int, default=3)
    pr.add_argument("--white-background", action="store_true")
    pr.add_argument("--cameras", default="",
                    help="optional INRIA cameras.json; default orbit")
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--width", type=int, default=1280)
    pr.add_argument("--height", type=int, default=720)
    pr.add_argument("--fx", type=float, default=1000.0)
    pr.add_argument("--radius", type=float, default=6.0)
    pr.add_argument("--orbit-height", type=float, default=1.0)
    pr.set_defaults(fn=cmd_render)
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
