"""Per-gaussian screen-space preprocessing, vectorized over N.

Standard 3DGS / EWA projection: camera-space transform, near/far cull, the
2D covariance J W Sigma W^T J^T (+ dilation) with the perspective Jacobian
clamped to 1.3 tan(fov/2), its inverse (the conic), SH colour and sigmoid
opacity, and opacity-aware per-axis binning extents. Differentiable by
autograd; the integer and boolean fields carry no gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..config import RasterConfig
from .camera import Camera
from .quaternion import normalize, quat_to_rotmat
from .sh import eval_sh_flat


@dataclasses.dataclass
class Projected:
    """Screen-space gaussians for one camera. All fields (N, ...) float32
    except `radius`/`radius_xy` (int32) and `valid` (bool)."""

    mean2d: torch.Tensor     # (N, 2) pixel-space centre
    depth: torch.Tensor      # (N,)   camera-space z
    conic: torch.Tensor      # (N, 3) upper triangle (a, b, c) of inv(cov2d)
    rgb: torch.Tensor        # (N, 3) view-dependent colour (SH evaluated)
    opacity: torch.Tensor    # (N,)   activated opacity in [0, 1]
    radius: torch.Tensor     # (N,)   int32 max bounding radius in px (0 = culled)
    radius_xy: torch.Tensor  # (N, 2) int32 per-axis half-extents (binning rect)
    valid: torch.Tensor      # (N,)   bool, visible and alive


def project_gaussians(
    means: torch.Tensor,           # (N, 3)
    quats: torch.Tensor,           # (N, 4) wxyz (unnormalized ok)
    log_scales: torch.Tensor,      # (N, 3)
    logit_opacities: torch.Tensor,  # (N,)
    sh: torch.Tensor,              # (N, 3K) FLAT band-major SH
    camera: Camera,
    cfg: RasterConfig,
    sh_degree: int = 3,
    alive: Optional[torch.Tensor] = None,   # (N,) bool
) -> Projected:
    f32 = torch.float32
    means = means.to(f32)
    if sh.ndim == 3:  # band-major (N, K, 3) -> flat
        sh = sh.reshape(sh.shape[0], -1)

    cam_pts = means @ camera.R.T + camera.t  # (N, 3)
    tx, ty, tz = cam_pts[:, 0], cam_pts[:, 1], cam_pts[:, 2]

    in_front = (tz > cfg.near) & (tz < cfg.far)
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    u = camera.fx * tx / tz_safe + camera.cx
    v = camera.fy * ty / tz_safe + camera.cy
    mean2d = torch.stack([u, v], dim=-1)

    # 3D covariance factor M = R diag(s): Sigma3d = M M^T.
    scales = torch.exp(log_scales.to(f32))
    R = quat_to_rotmat(normalize(quats.to(f32)))  # (N, 3, 3)
    M = R * scales[:, None, :]

    # T = J W with W the camera rotation; rows of T in closed form.
    tan_fovx, tan_fovy = camera.tan_half_fov()
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    txz = torch.clamp(tx / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(ty / tz_safe, -lim_y, lim_y)
    inv_z = 1.0 / tz_safe
    W = camera.R
    t0 = (camera.fx * inv_z)[:, None] * W[0][None, :] \
        - (camera.fx * txz * inv_z)[:, None] * W[2][None, :]   # (N, 3)
    t1 = (camera.fy * inv_z)[:, None] * W[1][None, :] \
        - (camera.fy * tyz * inv_z)[:, None] * W[2][None, :]   # (N, 3)
    # cov2d entries via t^T (M M^T) t' = (M^T t) . (M^T t').
    u0 = torch.sum(M * t0[:, :, None], dim=1)  # (N, 3)
    u1 = torch.sum(M * t1[:, :, None], dim=1)
    a = torch.sum(u0 * u0, dim=-1) + cfg.cov2d_dilation
    b = torch.sum(u0 * u1, dim=-1)
    c = torch.sum(u1 * u1, dim=-1) + cfg.cov2d_dilation

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    lambda1 = mid + disc
    radius_f = torch.ceil(cfg.sigma_radius * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    view_dir = means - camera.position[None, :]
    rgb = eval_sh_flat(sh.to(f32), view_dir, sh_degree)
    opacity = torch.sigmoid(logit_opacities.to(f32))

    # Opacity-aware support: alpha = op*exp(-q/2) >= alpha_min bounds the
    # visible region by q <= 2 ln(op / alpha_min), so the binning extents use
    # min(sigma_radius, sqrt(that)) sigmas (with a small slack).
    tau_op = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))
                    - float(math.log(cfg.alpha_min)))
    s_eff = torch.clamp(
        torch.sqrt(torch.clamp(tau_op, min=0.0)) * 1.001 + 1e-2,
        max=cfg.sigma_radius,
    )
    rx_f = torch.ceil(s_eff * torch.sqrt(torch.clamp(a, min=0.0)))
    ry_f = torch.ceil(s_eff * torch.sqrt(torch.clamp(c, min=0.0)))

    valid = in_front & det_ok & (radius_f > 0.0) & (opacity > cfg.alpha_min)
    if alive is not None:
        valid = valid & alive
    w, h = camera.width, camera.height
    on_screen = (
        (u + rx_f > 0.0) & (u - rx_f < w) & (v + ry_f > 0.0) & (v - ry_f < h)
    )
    valid = valid & on_screen

    zero = torch.zeros_like(radius_f)
    radius = torch.where(valid, radius_f, zero).to(torch.int32)
    radius_xy = torch.stack(
        [torch.where(valid, rx_f, zero), torch.where(valid, ry_f, zero)], dim=-1
    ).to(torch.int32)
    return Projected(
        mean2d=mean2d, depth=tz, conic=conic, rgb=rgb, opacity=opacity,
        radius=radius, radius_xy=radius_xy, valid=valid,
    )


# Payload channel layout consumed by the tile rasterizer (16 channels).
PAYLOAD_MX = 0
PAYLOAD_MY = 1
PAYLOAD_CA = 2   # conic a
PAYLOAD_CB = 3   # conic b
PAYLOAD_CC = 4   # conic c
PAYLOAD_OP = 5
PAYLOAD_R = 6
PAYLOAD_G = 7
PAYLOAD_B = 8
PAYLOAD_ONE = 9     # constant 1: the rasterizer accumulates the alpha-weight image
PAYLOAD_DEPTH = 10  # camera depth: the rasterizer accumulates the depth image
PAYLOAD_RADIUS = 11  # detached bounding radius (0 = culled)
PAYLOAD_RX = 12   # detached per-axis binning half-extents
PAYLOAD_RY = 13
PAYLOAD_DIM = 16


def make_payload(proj: Projected) -> torch.Tensor:
    """Pack the differentiable per-gaussian raster inputs into (N, 16)."""
    n = proj.mean2d.shape[0]
    ones = torch.ones((n,), dtype=torch.float32, device=proj.mean2d.device)
    cols = [
        proj.mean2d[:, 0],
        proj.mean2d[:, 1],
        proj.conic[:, 0],
        proj.conic[:, 1],
        proj.conic[:, 2],
        proj.opacity,
        proj.rgb[:, 0],
        proj.rgb[:, 1],
        proj.rgb[:, 2],
        ones,
        proj.depth,
        proj.radius.to(torch.float32),
        proj.radius_xy[:, 0].to(torch.float32),
        proj.radius_xy[:, 1].to(torch.float32),
    ]
    cols += [torch.zeros_like(ones)] * (PAYLOAD_DIM - len(cols))
    return torch.stack(cols, dim=-1)


def payload_to_projected(payload: torch.Tensor,
                         radius: Optional[torch.Tensor] = None,
                         radius_xy: Optional[torch.Tensor] = None,
                         valid: Optional[torch.Tensor] = None) -> Projected:
    """A Projected view over a (M, 16) payload (inverse of make_payload for
    the binning fields): the float fields are column views of it. The
    integer fields and `valid` are decoded from its channels unless given
    (P writes them beside the payload); zero rows decode as radius 0, i.e.
    invalid."""
    if radius is None:
        radius = payload[:, PAYLOAD_RADIUS].to(torch.int32)
        radius_xy = payload[:, PAYLOAD_RX : PAYLOAD_RY + 1].to(torch.int32)
        valid = radius > 0
    return Projected(
        mean2d=payload[:, PAYLOAD_MX : PAYLOAD_MY + 1],
        depth=payload[:, PAYLOAD_DEPTH],
        conic=payload[:, PAYLOAD_CA : PAYLOAD_CC + 1],
        rgb=payload[:, PAYLOAD_R : PAYLOAD_B + 1],
        opacity=payload[:, PAYLOAD_OP],
        radius=radius,
        radius_xy=radius_xy,
        valid=valid,
    )
