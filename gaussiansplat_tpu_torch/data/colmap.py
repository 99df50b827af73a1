"""COLMAP sparse-model binary readers (cameras.bin / images.bin /
points3D.bin): self-contained numpy implementations of the documented
COLMAP format. The reference package can also parse images.bin and
points3D.bin with a native library (its `data/native_loader.py`); the port
reads with numpy only.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from ..ops.camera import make_camera

# COLMAP camera model ids -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = _CAMERA_MODELS[model_id]
            params = _read(f, f"<{np_}d")
            cams[cam_id] = dict(model=name, width=int(w), height=int(h),
                                params=np.asarray(params))
    return cams


def read_images_bin(path: str) -> List[dict]:
    images = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(f, "<idddddddi")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.seek(24 * n2d, os.SEEK_CUR)  # skip 2D points (x, y, point3D_id)
            images.append(
                dict(id=img_id, quat=np.array([qw, qx, qy, qz]),
                     t=np.array([tx, ty, tz]), camera_id=cam_id,
                     name=name.decode())
            )
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        for i in range(n):
            _, x, y, z, r, g, b, _err = _read(f, "<QdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            (tl,) = _read(f, "<Q")
            f.seek(8 * tl, os.SEEK_CUR)  # skip track
    return xyz.astype(np.float32), (rgb.astype(np.float32) / 255.0)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _intrinsics(cam: dict) -> Tuple[float, float, float, float]:
    p = cam["params"]
    if cam["model"] == "SIMPLE_PINHOLE" or cam["model"] in (
        "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL", "RADIAL_FISHEYE",
        "FOV",
    ):
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    # PINHOLE-family: fx fy cx cy (distortion params ignored — 3DGS assumes
    # undistorted images, as does the INRIA loader)
    return float(p[0]), float(p[1]), float(p[2]), float(p[3])


def read_colmap_model(sparse_dir: str, device="cuda"):
    """Returns ([(image_name, Camera)], points_xyz (N,3), colors (N,3)); the
    cameras on `device`, the points as numpy arrays."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    xyz, rgb = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    out = []
    for im in sorted(images, key=lambda d: d["name"]):
        cam = cams[im["camera_id"]]
        fx, fy, cx, cy = _intrinsics(cam)
        R = _quat_to_rot(im["quat"])   # COLMAP stores world-to-cam rotation
        out.append(
            (
                im["name"],
                make_camera(R=R, t=im["t"], fx=fx, fy=fy,
                            width=cam["width"], height=cam["height"],
                            cx=cx, cy=cy, device=device),
            )
        )
    return out, xyz, rgb
