"""INRIA `cameras.json` reader.

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

