"""Command-line entry points of the port: `train`, `render`, `eval`.

  python -m gaussiansplat_tpu_torch train --scene synthetic --out runs/x
  python -m gaussiansplat_tpu_torch render --ply scene.ply
  python -m gaussiansplat_tpu_torch eval --scene synthetic --ply scene.ply

`train` trains a scene ('synthetic', 'benchmark', a NeRF-synthetic
directory or a COLMAP directory) through the full schedule with held-out
evaluation, preview PNGs and checkpoints (`--resume` continues after the
latest one), and exports `point_cloud.ply`; `render` renders a PLY scene
from orbit cameras (or an INRIA cameras.json) to PNG frames; `eval` prints
the PSNR/SSIM of a PLY scene on a scene's test views as one JSON line. The
device defaults to the card; `--device cpu` runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import RasterConfig, TrainConfig
from .data.cameras import load_cameras_json
from .ops.camera import orbit_camera
from .render import render
from .utils.checkpoint import export_ply, import_ply


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


def _load_scene(args):
    from .data.datasets import colmap_scene, nerf_synthetic_scene, synthetic_scene

    device = torch.device(args.device)
    if args.scene == "synthetic":
        scene, _ = synthetic_scene(
            torch.Generator().manual_seed(args.seed),
            n_gaussians=args.synthetic_n, width=args.synthetic_size,
            height=args.synthetic_size, device=device,
        )
        return scene
    if args.scene == "benchmark":
        from .data.benchmark import benchmark_scene

        size = args.synthetic_size if args.synthetic_size != 256 else 800
        scene, _ = benchmark_scene(
            width=size, height=size, capacity=args.capacity or None,
            seed=args.seed, device=device,
        )
        return scene
    if os.path.exists(os.path.join(args.scene, "transforms_train.json")):
        return nerf_synthetic_scene(
            args.scene, white_background=args.white_background,
            downscale=args.downscale, capacity=args.capacity or None,
            n_init=args.n_init, device=device,
        )
    if os.path.isdir(os.path.join(args.scene, "sparse")):
        return colmap_scene(
            args.scene, downscale=args.downscale,
            capacity=args.capacity or None, device=device,
        )
    raise SystemExit(
        f"unrecognized scene '{args.scene}': expected 'synthetic', "
        "'benchmark' (bundled 150k-gaussian quality scene), a NeRF-synthetic "
        "dir (transforms_train.json) or a COLMAP dir (sparse/)"
    )


def _background(args, device) -> torch.Tensor:
    return torch.full((3,), 1.0 if args.white_background else 0.0,
                      dtype=torch.float32, device=device)


def cmd_train(args) -> int:
    from .train.trainer import Trainer
    from .utils.logging import MetricLogger

    scene = _load_scene(args)
    tcfg = TrainConfig(
        iterations=args.iterations,
        white_background=args.white_background,
        sh_degree=args.sh_degree,
        eval_every=args.eval_every,
    )
    rcfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    os.makedirs(args.out, exist_ok=True)
    logger = MetricLogger(os.path.join(args.out, "metrics.jsonl"))
    try:
        model, metrics = Trainer(raster_cfg=rcfg, cfg=tcfg).fit(
            scene.init_model,
            scene.train_views,
            log=logger.log,
            ckpt_dir=os.path.join(args.out, "ckpts"),
            resume=args.resume,
            eval_views=scene.test_views[: args.eval_views] or None,
            preview_dir=(None if args.no_previews
                         else os.path.join(args.out, "previews")),
        )
    finally:
        logger.close()
    n = export_ply(os.path.join(args.out, "point_cloud.ply"), model)
    print(f"trained {args.iterations} iters on '{scene.name}': "
          f"final loss={metrics.get('loss', float('nan')):.4f} "
          f"psnr={metrics.get('psnr', float('nan')):.2f} "
          f"-> {n} gaussians exported to {args.out}/point_cloud.ply")
    return 0


def cmd_eval(args) -> int:
    from .train.loss import psnr, ssim

    scene = _load_scene(args)
    device = torch.device(args.device)
    model = import_ply(args.ply, device=device)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    bg = _background(args, device)
    psnrs, ssims = [], []
    with torch.inference_mode():
        for cam, gt in scene.test_views:
            img = render(model, cam, cfg, sh_degree=args.sh_degree,
                         background=bg).image
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
    print(json.dumps(dict(
        scene=scene.name, n_views=len(psnrs),
        psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)),
    )))
    return 0


def cmd_render(args) -> int:
    device = torch.device(args.device)
    model = import_ply(args.ply, device=device)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    bg = _background(args, device)
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


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="synthetic",
                   help="'synthetic', 'benchmark', NeRF-synthetic dir, or "
                        "COLMAP dir")
    p.add_argument("--synthetic-n", type=int, default=1024)
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--capacity", type=int, default=0)
    p.add_argument("--n-init", type=int, default=100_000,
                   help="random-init gaussian count for NeRF-synthetic "
                        "scenes (COLMAP scenes init from SfM points)")
    p.add_argument("--seed", type=int, default=0)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (plain versions)")
    p.add_argument("--pairs-per-gaussian", type=float, default=8.0,
                   help="static pair-list capacity as a multiple of N "
                        "(overflow is counted, never reallocated)")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--white-background", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gaussiansplat_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train a 3DGS scene")
    _add_scene_args(pt)
    _add_common(pt)
    pt.add_argument("--iterations", type=int, default=7000)
    pt.add_argument("--out", default="runs/out")
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--eval-every", type=int, default=1000,
                    help="held-out PSNR/SSIM (+ preview PNG) cadence")
    pt.add_argument("--eval-views", type=int, default=8,
                    help="number of test views scored per eval")
    pt.add_argument("--no-previews", action="store_true")
    pt.set_defaults(fn=cmd_train)

    pr = sub.add_parser("render", help="render a PLY scene to images")
    _add_common(pr)
    pr.add_argument("--ply", required=True)
    pr.add_argument("--out", default="renders")
    pr.add_argument("--cameras", default="",
                    help="optional INRIA cameras.json; default orbit")
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--width", type=int, default=1280)
    pr.add_argument("--height", type=int, default=720)
    pr.add_argument("--fx", type=float, default=1000.0)
    pr.add_argument("--radius", type=float, default=6.0)
    pr.add_argument("--orbit-height", type=float, default=1.0)
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("eval", help="PSNR/SSIM of a PLY against a scene")
    _add_scene_args(pe)
    _add_common(pe)
    pe.add_argument("--ply", required=True)
    pe.set_defaults(fn=cmd_eval)
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
