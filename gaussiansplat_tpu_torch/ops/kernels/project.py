"""P, the projection and the raster payload in one pass: CUDA kernel
(csrc/project.cu) and a plain per-gaussian twin of its loop.

For each gaussian the kernel writes what `ops/projection.project_gaussians`
and `make_payload` (the plain version) compute from the same inputs: the
(N, 16) float32 payload row in `make_payload`'s channel layout (channels
14-15 zero), the radius, the per-axis extents and `valid`. It builds no
autograd graph: calls that need a gradient take the plain version.

`project_twin` walks one gaussian at a time with numpy float32 scalars in
the kernel's order of operations: the CPU tests hold it to the plain
version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from ..camera import Camera
from ..projection import PAYLOAD_DIM
from ..sh import SH_C0, SH_C1, SH_C2, SH_C3, num_sh_coeffs
from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

PROJECT = CudaKernel(
    "project.cu", "gs_project",
    # means, quats, log_scales, logit, sh_dc, sh_rest, alive, R, t, fx, fy,
    # cx, cy, n, rest, sh_degree, width, height, near, far, dilation,
    # sigma_radius, alpha_min, log_alpha_min, payload, radius, radius_xy,
    # valid, stream
    [_P] * 13 + [_I] * 5 + [_F] * 6 + [_P] * 5,
)

# Floats of an sh_rest row the kernel takes: SH degrees 0-3.
REST_WIDTHS = tuple(3 * (num_sh_coeffs(d) - 1) for d in range(4))

__all__ = ["PROJECT", "project_cuda", "project_twin"]


def _check_inputs(means, quats, log_scales, logit_opacities, sh_dc, sh_rest,
                  alive, sh_degree: int) -> int:
    n = means.shape[0] if means.ndim else 0
    rest = sh_rest.shape[1] if sh_rest.ndim == 2 else -1
    for name, t, dtype, shape in (
            ("means", means, torch.float32, (n, 3)),
            ("quats", quats, torch.float32, (n, 4)),
            ("log_scales", log_scales, torch.float32, (n, 3)),
            ("logit_opacities", logit_opacities, torch.float32, (n,)),
            ("sh_dc", sh_dc, torch.float32, (n, 3)),
            ("sh_rest", sh_rest, torch.float32, (n, rest)),
            ("alive", alive, torch.bool, (n,))):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rest not in REST_WIDTHS:
        raise ValueError(f"sh_rest must have one of {REST_WIDTHS} columns "
                         f"(SH degree 0-3), got {rest}")
    if not 0 <= sh_degree <= 3 or num_sh_coeffs(sh_degree) > 1 + rest // 3:
        raise ValueError(f"sh_degree {sh_degree} needs SH bands that "
                         f"sh_rest of {rest} columns does not hold")
    return n


def project_cuda(means, quats, log_scales, logit_opacities, sh_dc, sh_rest,
                 alive, camera: Camera, cfg, sh_degree: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Launch P on the current stream: (payload, radius, radius_xy, valid),
    the (N, PAYLOAD_DIM) float32 payload, int32 (N,) and (N, 2), bool (N,).
    The model's fields as `project_gaussians` takes them (`sh_dc` and
    `sh_rest` apart, contiguous float32) and the camera's tensors, all on
    one CUDA device."""
    n = _check_inputs(means, quats, log_scales, logit_opacities, sh_dc,
                      sh_rest, alive, sh_degree)
    cam = (camera.R, camera.t, camera.fx, camera.fy, camera.cx, camera.cy)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in cam):
        raise ValueError("the camera's tensors must be contiguous float32")
    devices = {t.device for t in (means, quats, log_scales, logit_opacities,
                                  sh_dc, sh_rest, alive, *cam)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"project_cuda needs CUDA tensors on one device, "
                         f"got {sorted(map(str, devices))}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"P takes 1 <= N < 2^31 gaussians (N={n})")
    dev = means.device
    payload = torch.empty((n, PAYLOAD_DIM), dtype=torch.float32, device=dev)
    radius = torch.empty((n,), dtype=torch.int32, device=dev)
    radius_xy = torch.empty((n, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    PROJECT.launch(
        *(t.data_ptr() for t in (means, quats, log_scales, logit_opacities,
                                 sh_dc, sh_rest, alive, *cam)),
        n, sh_rest.shape[1], sh_degree, camera.width, camera.height,
        cfg.near, cfg.far, cfg.cov2d_dilation, cfg.sigma_radius,
        cfg.alpha_min, math.log(cfg.alpha_min),
        payload.data_ptr(), radius.data_ptr(), radius_xy.data_ptr(),
        valid.data_ptr(), stream,
    )
    return payload, radius, radius_xy, valid


def _sh_basis(x, y, z, degree: int):
    """The real SH basis of a unit direction, in csrc/project.cu's order."""
    f = np.float32
    basis = [f(SH_C0)]
    if degree >= 1:
        basis += [f(-SH_C1) * y, f(SH_C1) * z, f(-SH_C1) * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c2 = [f(c) for c in SH_C2]
        basis += [c2[0] * xy, c2[1] * yz, c2[2] * (f(2) * zz - xx - yy),
                  c2[3] * xz, c2[4] * (xx - yy)]
        if degree >= 3:
            c3 = [f(c) for c in SH_C3]
            basis += [c3[0] * y * (f(3) * xx - yy), c3[1] * xy * z,
                      c3[2] * y * (f(4) * zz - xx - yy),
                      c3[3] * z * (f(2) * zz - f(3) * xx - f(3) * yy),
                      c3[4] * x * (f(4) * zz - xx - yy),
                      c3[5] * z * (xx - yy), c3[6] * x * (xx - f(3) * yy)]
    return basis


def project_twin(means, quats, log_scales, logit_opacities, sh_dc, sh_rest,
                 alive, camera: Camera, cfg, sh_degree: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of csrc/project.cu, one gaussian at a time: the same
    (payload, radius, radius_xy, valid) from CPU tensors, each float
    expression in the kernel's order with numpy float32 scalars (a fused
    multiply-add through float64, which rounds twice where the card rounds
    once, about once in 2^29; numpy's exp and log may round an ULP apart
    from the card's). Slow (a Python loop): for small test scenes."""
    f = np.float32
    n = _check_inputs(means, quats, log_scales, logit_opacities, sh_dc,
                      sh_rest, alive, sh_degree)
    m_, q_, ls_, lo_, dc_, rest_ = (t.detach().numpy().astype(f) for t in (
        means, quats, log_scales, logit_opacities, sh_dc, sh_rest))
    ok = alive.numpy()
    W = camera.R.detach().numpy().astype(f).reshape(9)
    tc = camera.t.detach().numpy().astype(f)
    fx, fy, cx, cy = (f(t.item()) for t in (camera.fx, camera.fy, camera.cx,
                                            camera.cy))
    width, height = f(camera.width), f(camera.height)
    near, far, dil = f(cfg.near), f(cfg.far), f(cfg.cov2d_dilation)
    sigma, amin = f(cfg.sigma_radius), f(cfg.alpha_min)
    log_amin = f(math.log(cfg.alpha_min))
    eps, one, two, half = f(1e-12), f(1), f(2), f(0.5)
    k_sh = num_sh_coeffs(sh_degree)

    def clamp_min(x, lo):    # torch.clamp(x, min=lo), NaN kept
        return x if (x > lo or x != x) else lo

    def clamp_max(x, hi):
        return x if (x < hi or x != x) else hi

    def gemm3(a, b):    # csrc/project.cu's `gemm3`: a0 b0, then two FMAs
        acc = np.float64(a[0] * b[0])
        for k in (1, 2):
            acc = np.float64(f(np.float64(a[k]) * np.float64(b[k]) + acc))
        return f(acc)

    lim_x = f(1.3) * ((one / fx) * (half * width))
    lim_y = f(1.3) * ((one / fy) * (half * height))
    # The camera centre -R^T t.
    pos = [-((W[k] * tc[0] + W[3 + k] * tc[1]) + W[6 + k] * tc[2])
           for k in range(3)]
    payload = np.zeros((n, PAYLOAD_DIM), f)
    radius = np.zeros(n, np.int32)
    radius_xy = np.zeros((n, 2), np.int32)
    valid = np.zeros(n, bool)
    with np.errstate(all="ignore"):
        for i in range(n):
            m0, m1, m2 = m_[i]
            tx = gemm3(m_[i], W[0:3]) + tc[0]
            ty = gemm3(m_[i], W[3:6]) + tc[1]
            tz = gemm3(m_[i], W[6:9]) + tc[2]
            in_front = near < tz < far
            tzs = tz if in_front else one
            u = fx * tx / tzs + cx
            v = fy * ty / tzs + cy

            sx, sy, sz = np.exp(ls_[i])
            qw, qx, qy, qz = q_[i]
            qn = clamp_min(np.sqrt(((qw * qw + qx * qx) + qy * qy) + qz * qz),
                           eps)
            qw, qx, qy, qz = qw / qn, qx / qn, qy / qn, qz / qn
            M = [(one - two * (qy * qy + qz * qz)) * sx,
                 (two * (qx * qy - qw * qz)) * sy,
                 (two * (qx * qz + qw * qy)) * sz,
                 (two * (qx * qy + qw * qz)) * sx,
                 (one - two * (qx * qx + qz * qz)) * sy,
                 (two * (qy * qz - qw * qx)) * sz,
                 (two * (qx * qz - qw * qy)) * sx,
                 (two * (qy * qz + qw * qx)) * sy,
                 (one - two * (qx * qx + qy * qy)) * sz]

            txz = clamp_max(clamp_min(tx / tzs, -lim_x), lim_x)
            tyz = clamp_max(clamp_min(ty / tzs, -lim_y), lim_y)
            inv_z = one / tzs
            ax, bx = fx * inv_z, fx * txz * inv_z
            ay, by = fy * inv_z, fy * tyz * inv_z
            t0 = [ax * W[k] - bx * W[6 + k] for k in range(3)]
            t1 = [ay * W[3 + k] - by * W[6 + k] for k in range(3)]
            u0 = [(M[c] * t0[0] + M[3 + c] * t0[1]) + M[6 + c] * t0[2]
                  for c in range(3)]
            u1 = [(M[c] * t1[0] + M[3 + c] * t1[1]) + M[6 + c] * t1[2]
                  for c in range(3)]
            a = ((u0[0] * u0[0] + u0[1] * u0[1]) + u0[2] * u0[2]) + dil
            b = (u0[0] * u1[0] + u0[1] * u1[1]) + u0[2] * u1[2]
            c = ((u1[0] * u1[0] + u1[1] * u1[1]) + u1[2] * u1[2]) + dil
            det = a * c - b * b
            det_ok = det > 0
            inv_det = one / (det if det_ok else one)
            mid = half * (a + c)
            disc = np.sqrt(clamp_min(mid * mid - det, f(0.01)))
            radius_f = np.ceil(sigma * np.sqrt(clamp_min(mid + disc, f(0))))

            d = [m0 - pos[0], m1 - pos[1], m2 - pos[2]]
            dn = clamp_min(np.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]),
                           eps)
            basis = _sh_basis(d[0] / dn, d[1] / dn, d[2] / dn, sh_degree)
            rgb = basis[0] * dc_[i]
            for k in range(1, k_sh):
                rgb = rgb + basis[k] * rest_[i, 3 * (k - 1): 3 * k]
            rgb = np.maximum(rgb + half, f(0))

            op = one / (one + np.exp(-lo_[i]))
            tau = two * (np.log(clamp_min(op, eps)) - log_amin)
            s_eff = clamp_max(np.sqrt(clamp_min(tau, f(0))) * f(1.001)
                              + f(1e-2), sigma)
            rx_f = np.ceil(s_eff * np.sqrt(clamp_min(a, f(0))))
            ry_f = np.ceil(s_eff * np.sqrt(clamp_min(c, f(0))))
            on_screen = (u + rx_f > 0 and u - rx_f < width
                         and v + ry_f > 0 and v - ry_f < height)
            valid[i] = (in_front and det_ok and radius_f > 0 and op > amin
                        and ok[i] and on_screen)
            if valid[i]:
                radius[i] = int(radius_f)
                radius_xy[i] = (int(rx_f), int(ry_f))
            payload[i, :14] = (u, v, c * inv_det, -b * inv_det, a * inv_det,
                               op, *rgb, one, tz, radius[i], *radius_xy[i])
    return (torch.from_numpy(payload), torch.from_numpy(radius),
            torch.from_numpy(radius_xy), torch.from_numpy(valid))
