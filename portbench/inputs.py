"""A cell's inputs, made from the seed: the scene, the camera poses and,
for training, the views' order and targets. Configuration and traffic
files say which generator and with what parameters; the program file
(portbench/programs/) makes the scene and the targets, this module the
traffic. The same seed gives the same inputs. Both the program and the
reference are handed these.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import render as R
from .reference import scenes

# Views a training cell's order covers: more steps than any window takes.
ORDER_LENGTH = 20_000


@dataclasses.dataclass
class Pose:
    """A camera as host numbers: world-to-camera R (3, 3), t (3,) float32."""

    R: np.ndarray
    t: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def ref_camera(pose: Pose, device) -> R.Camera:
    return R.Camera(R=torch.as_tensor(pose.R).to(device),
                    t=torch.as_tensor(pose.t).to(device), fx=pose.fx,
                    fy=pose.fy, cx=pose.cx, cy=pose.cy, width=pose.width,
                    height=pose.height)


def _pose(eye, target, up, fx: float, width: int, height: int) -> Pose:
    rot, t = scenes.look_at(eye, target, up)
    return Pose(R=rot, t=t, fx=float(fx), fy=float(fx), cx=(width - 1) / 2.0,
                cy=(height - 1) / 2.0, width=int(width), height=int(height))


@dataclasses.dataclass
class Inputs:
    params: Dict[str, torch.Tensor]  # initial parameters, never handed out
    alive: torch.Tensor
    sh_degree: int                   # the degree the cell renders with
    poses: List[Pose]                # serve: requests in order; train: views
    background: torch.Tensor         # (3,)
    order: Optional[List[int]] = None           # train: view of each step
    targets: Optional[List[torch.Tensor]] = None  # train: (H, W, 3) a view
    extent: float = 1.0              # train: scene extent of the position lr
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed of stream k of `seed`."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


ORIGIN, UP = (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)


def _orbit_poses(tr: dict, rng: np.random.Generator) -> List[Pose]:
    n = tr["poses"]
    lo, hi = (math.radians(d) for d in tr["step_deg"])
    angles = rng.uniform(0, 2 * math.pi) + np.cumsum(rng.uniform(lo, hi, n))
    e_lo, e_hi = (math.radians(d) for d in tr["elevation_deg"])
    elev = rng.uniform(e_lo, e_hi, n)
    return [_pose(scenes.orbit_eye(float(a), float(e), tr["radius"]), ORIGIN,
                  UP, tr["fx"], tr["width"], tr["height"])
            for a, e in zip(angles, elev)]


def _views(config: dict, tr: dict, rng: np.random.Generator) -> List[Pose]:
    v = tr["views"]
    if v["kind"] == "orbit":
        a0 = rng.uniform(0, 2 * math.pi)
        el = math.radians(v["elevation_deg"])
        return [_pose(scenes.orbit_eye(a0 + 2 * math.pi * k / v["count"], el,
                                       tr["radius"]), ORIGIN, UP, tr["fx"],
                      tr["width"], tr["height"])
                for k in range(v["count"])]
    if v["kind"] == "hemisphere":
        return [_pose(eye, (0.0, 0.45, 0.0), (0.0, -1.0, 0.0),
                      1.25 * tr["width"], tr["width"], tr["height"])
                for eye in scenes.hemisphere_eyes(config["train_views"])]
    raise ValueError(f"unknown views kind {v['kind']!r}")


def make(cell, program, seed: int, device) -> Inputs:
    """The cell's inputs: the program file's scene and, for training, its
    targets; the poses, the views' order and the background from the
    traffic mix."""
    config, tr = cell.config, cell.traffic
    t0 = time.perf_counter()
    params, alive = program.scene(config, seed, device)
    sync(device)
    t1 = time.perf_counter()
    rng = np.random.default_rng(sub_seed(seed, 1))
    bg = torch.tensor(tr.get("background", [0.0, 0.0, 0.0]),
                      dtype=torch.float32, device=device)
    if tr["kind"] == "serve":
        return Inputs(params=params, alive=alive,
                      sh_degree=config["scene"]["sh_degree"],
                      poses=_orbit_poses(tr, rng), background=bg,
                      seconds=dict(scene_s=t1 - t0))
    if tr["kind"] != "train":
        raise ValueError(f"unknown traffic kind {tr['kind']!r}")
    poses = _views(config, tr, rng)
    order_rng = np.random.default_rng(sub_seed(seed, 3))
    order: List[int] = []
    while len(order) < ORDER_LENGTH:
        order += order_rng.permutation(len(poses)).tolist()
    targets = program.targets(config, tr, params, alive, poses, seed, device)
    sync(device)
    from .reference.train import extent_of

    return Inputs(params=params, alive=alive, sh_degree=tr["sh_degree"],
                  poses=poses, background=bg, order=order, targets=targets,
                  extent=extent_of(params["means"], alive),
                  seconds=dict(scene_s=t1 - t0,
                               targets_s=time.perf_counter() - t1))
