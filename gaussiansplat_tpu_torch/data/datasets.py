"""Dataset loaders and synthetic scene generation.

  * `synthetic_scene`: a random gaussian soup as ground truth, rendered by
    the oracle from orbit cameras; needs no downloaded data.
  * `load_nerf_synthetic` / `nerf_synthetic_scene`: Blender
    `transforms_{split}.json` scenes.
  * `colmap_scene`: COLMAP sparse reconstructions (data/colmap.py).

Images are float32 (H, W, 3) tensors in [0, 1] on the scene's device (the
card unless the caller passes `device="cpu"`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RasterConfig
from ..models.gaussians import GaussianModel, from_points, random_model
from ..ops.camera import Camera, fov_to_focal, make_camera, orbit_camera
from ..ops.oracle import render_oracle
from ..ops.projection import project_gaussians


@dataclasses.dataclass
class Scene:
    """A training scene: cameras with ground-truth images, plus an initial
    model (from SfM points or random)."""

    train_views: List[Tuple[Camera, torch.Tensor]]
    test_views: List[Tuple[Camera, torch.Tensor]]
    init_model: GaussianModel
    name: str = "scene"


@torch.no_grad()
def _orbit_views(gt_model: GaussianModel, count: int, offset: float,
                 width: int, height: int, fx: float, radius: float,
                 cfg: RasterConfig, sh_degree: int):
    """`count` orbit cameras (angles 2 pi (i + offset) / count, 1.5 above
    the origin) with the oracle render of `gt_model` as ground truth."""
    m = gt_model
    out = []
    for i in range(count):
        angle = 2.0 * math.pi * (i + offset) / max(count, 1)
        cam = orbit_camera(angle, radius, height_offset=1.5, fx=fx, fy=fx,
                           width=width, height=height, device=m.device)
        proj = project_gaussians(m.means, m.quats, m.log_scales,
                                 m.logit_opacities, m.sh, cam, cfg,
                                 sh_degree=sh_degree, alive=m.alive)
        img, _ = render_oracle(proj, cam.width, cam.height, cfg)
        out.append((cam, img))
    return out


def synthetic_scene(
    generator: torch.Generator,
    n_gaussians: int = 1024,
    n_train: int = 24,
    n_test: int = 4,
    width: int = 256,
    height: int = 256,
    capacity: Optional[int] = None,
    sh_degree: int = 1,
    fx: float = 300.0,
    radius: float = 6.0,
    cfg: Optional[RasterConfig] = None,
    device="cuda",
) -> Tuple[Scene, GaussianModel]:
    """Procedural scene: a random gaussian soup (drawn first from
    `generator`) is the ground truth; GT images are oracle renders; the
    init model is a fresh soup (drawn next) at opacity 0.3. Returns
    (scene, ground_truth_model)."""
    cfg = cfg or RasterConfig()
    gt_model = random_model(generator, n_gaussians, sh_degree=sh_degree,
                            extent=1.0, device=device)
    init = random_model(generator, n_gaussians, sh_degree=sh_degree,
                        extent=1.0, capacity=capacity or 4 * n_gaussians,
                        opacity=0.3, device=device)
    views = lambda count, offset: _orbit_views(
        gt_model, count, offset, width, height, fx, radius, cfg, sh_degree)
    scene = Scene(
        train_views=views(n_train, 0.0),
        test_views=views(n_test, 0.37),
        init_model=init,
        name=f"synthetic{n_gaussians}",
    )
    return scene, gt_model


def _load_image(path: str, white_background: bool) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4]
        bg = 1.0 if white_background else 0.0
        img = img[..., :3] * alpha + bg * (1.0 - alpha)
    return img


def _image_tensor(img: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(img, np.float32)).to(device)


def load_nerf_synthetic(
    root: str,
    split: str = "train",
    white_background: bool = False,
    downscale: int = 1,
    limit: Optional[int] = None,
    device="cuda",
) -> List[Tuple[Camera, torch.Tensor]]:
    """Blender/NeRF-synthetic `transforms_{split}.json` loader.

    Blender camera convention: +x right, +y up, -z forward (OpenGL); it is
    converted to the COLMAP-style +z-forward, +y-down frame of the
    projector.
    """
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])
    views = []
    frames = meta["frames"][:limit] if limit else meta["frames"]
    for frame in frames:
        img_path = os.path.join(root, frame["file_path"] + ".png")
        if not os.path.exists(img_path):
            img_path = os.path.join(root, frame["file_path"])
        img = _load_image(img_path, white_background)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        h, w = img.shape[:2]
        c2w = np.asarray(frame["transform_matrix"], np.float32)
        # flip y/z axes: OpenGL cam-to-world -> COLMAP cam-to-world
        c2w[:3, 1:3] *= -1.0
        R = c2w[:3, :3].T            # world-to-camera rotation
        t = -R @ c2w[:3, 3]
        fx = fov_to_focal(fovx, w)
        views.append((make_camera(R=R, t=t, fx=fx, fy=fx, width=w, height=h,
                                  device=device),
                      _image_tensor(img, device)))
    return views


def nerf_synthetic_scene(
    root: str,
    white_background: bool = False,
    n_init: int = 100_000,
    capacity: Optional[int] = None,
    downscale: int = 1,
    limit: Optional[int] = None,
    device="cuda",
) -> Scene:
    train = load_nerf_synthetic(root, "train", white_background, downscale,
                                limit, device=device)
    try:
        test = load_nerf_synthetic(root, "test", white_background, downscale,
                                   limit=limit or 8, device=device)
    except FileNotFoundError:
        test = train[:2]
    # 3DGS random init inside a box for synthetic scenes
    rng = np.random.default_rng(0)
    pts = (rng.random((n_init, 3), dtype=np.float32) * 2.6 - 1.3)
    cols = rng.random((n_init, 3), dtype=np.float32)
    init = from_points(pts, cols, capacity=capacity, device=device)
    return Scene(train, test, init, name=os.path.basename(root.rstrip("/")))


def colmap_scene(
    root: str,
    images_dir: str = "images",
    downscale: int = 1,
    capacity: Optional[int] = None,
    limit: Optional[int] = None,
    test_every: int = 8,
    device="cuda",
) -> Scene:
    """COLMAP scene (Mip-NeRF360 / Tanks&Temples layout: sparse/0 + images);
    every `test_every`-th image is held out."""
    from .colmap import read_colmap_model

    cams, pts, cols = read_colmap_model(os.path.join(root, "sparse", "0"),
                                        device=device)
    views = []
    for name, cam in cams[:limit] if limit else cams:
        img_path = os.path.join(root, images_dir, name)
        if not os.path.exists(img_path):
            continue
        img = _load_image(img_path, False)
        if downscale > 1:
            img = img[::downscale, ::downscale]
            cam = cam.resized(img.shape[1], img.shape[0])
        views.append((cam, _image_tensor(img, device)))
    train = [v for i, v in enumerate(views) if i % test_every != 0]
    test = [v for i, v in enumerate(views) if i % test_every == 0]
    init = from_points(pts, cols, capacity=capacity, device=device)
    return Scene(train, test, init, name=os.path.basename(root.rstrip("/")))
