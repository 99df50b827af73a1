"""INRIA `cameras.json` reader and writer.

Per camera the file holds `position` (camera centre, world), `rotation` (3x3
camera-to-world, row-major lists), `fx, fy, width, height, img_name, id`. The
projector uses the world-to-camera form: R = rot^T, t = -rot^T @ position.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from ..ops.camera import Camera, make_camera


def load_cameras_json(path: str, device="cuda") -> List[Camera]:
    with open(path) as f:
        entries = json.load(f)
    cams = []
    for e in sorted(entries, key=lambda d: d.get("id", 0)):
        rot = np.asarray(e["rotation"], np.float32)      # camera-to-world
        pos = np.asarray(e["position"], np.float32)
        R = rot.T
        cams.append(make_camera(
            R=R, t=-R @ pos, fx=float(e["fx"]), fy=float(e["fy"]),
            width=int(e["width"]), height=int(e["height"]), device=device,
        ))
    return cams



def save_cameras_json(path: str, cameras: List[Camera]) -> None:
    entries = []
    for i, c in enumerate(cameras):
        R = c.R.detach().cpu().numpy()
        entries.append(dict(
            id=i, img_name=f"{i:05d}", width=int(c.width), height=int(c.height),
            position=c.position.detach().cpu().numpy().tolist(),
            rotation=R.T.tolist(), fx=float(c.fx), fy=float(c.fy),
        ))
    with open(path, "w") as f:
        json.dump(entries, f)
