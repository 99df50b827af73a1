"""Camera model: pinhole intrinsics + world-to-camera extrinsics.

Convention (COLMAP / INRIA): x_cam = R @ x_world + t, the camera looks down
+z, pixel u = fx * x/z + cx, v = fy * y/z + cy.

Camera builders compute in float32 on the CPU and then move the result to
`device` (the card unless the caller asks for the CPU); `render()` moves a
camera to its model's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    """A single pinhole camera: tensors plus the integer image size."""

    R: torch.Tensor     # (3, 3) world-to-camera rotation
    t: torch.Tensor     # (3,)   world-to-camera translation
    fx: torch.Tensor    # () focal length in pixels
    fy: torch.Tensor
    cx: torch.Tensor    # () principal point in pixels
    cy: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def device(self) -> torch.device:
        return self.R.device

    @property
    def position(self) -> torch.Tensor:
        """Camera centre in world space: -R^T t."""
        return -self.R.T @ self.t

    def tan_half_fov(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return 0.5 * self.width / self.fx, 0.5 * self.height / self.fy

    def resized(self, width: int, height: int) -> "Camera":
        """The camera of a rescaled image with the same field of view."""
        sx = width / self.width
        sy = height / self.height
        return dataclasses.replace(
            self, fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx,
            cy=self.cy * sy, width=int(width), height=int(height),
        )

    def to(self, device) -> "Camera":
        mv = lambda x: x.to(device)
        return dataclasses.replace(
            self, R=mv(self.R), t=mv(self.t), fx=mv(self.fx), fy=mv(self.fy),
            cx=mv(self.cx), cy=mv(self.cy),
        )


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.array(v, np.float32))


def make_camera(
    R,
    t,
    fx: float,
    fy: float,
    width: int,
    height: int,
    cx: float | None = None,
    cy: float | None = None,
    device="cuda",
) -> Camera:
    if cx is None:
        cx = (width - 1) / 2.0
    if cy is None:
        cy = (height - 1) / 2.0
    return Camera(
        R=_f32(R), t=_f32(t), fx=_f32(fx), fy=_f32(fy), cx=_f32(cx),
        cy=_f32(cy), width=int(width), height=int(height),
    ).to(device)


def camera_from_numpy(R, t, fx, fy, cx, cy, width: int, height: int,
                      device="cuda") -> Camera:
    """A Camera from host arrays, e.g. the fields of a reference-package
    camera passed through `np.asarray`."""
    return make_camera(R, t, float(fx), float(fy), width, height,
                       cx=float(cx), cy=float(cy), device=device)


def look_at(
    eye,
    target,
    up=(0.0, 1.0, 0.0),
    fx: float = 3200.0,
    fy: float = 3200.0,
    width: int = 512,
    height: int = 512,
    device="cuda",
) -> Camera:
    """Camera from eye/target/up. Basis: forward w = normalize(target - eye),
    right u = normalize(up x w), true-up v = w x u; the rows of R are
    (u, v, w), so +z is forward."""
    eye, target, up = _f32(eye), _f32(target), _f32(up)
    w = target - eye
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(up, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)
    R = torch.stack([u, v, w], dim=0)
    t = -R @ eye
    return make_camera(R, t, fx, fy, width, height, device=device)


def orbit_camera(
    angle: float,
    radius: float,
    height_offset: float = 0.0,
    target=(0.0, 0.0, 0.0),
    **kwargs: Any,
) -> Camera:
    """Camera on a circular orbit around `target`."""
    target = _f32(target)
    eye = target + _f32(
        [radius * math.sin(angle), height_offset, radius * math.cos(angle)])
    return look_at(eye, target, **kwargs)


def fov_to_focal(fov: float, pixels: int) -> float:
    """Field of view (radians) -> focal length in pixels."""
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))
