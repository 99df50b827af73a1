"""Quaternion math, vectorized over the gaussian axis. Quaternions are
(w, x, y, z)."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions, shape (..., 4)."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz unit quaternions -> (..., 3, 3) rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_covariance_3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = R S S^T R^T, (..., 3, 3).

    quats: (..., 4), need not be normalized; scales: (..., 3) linear
    standard deviations (callers exponentiate log-scales first)."""
    R = quat_to_rotmat(normalize(quats))
    M = R * scales[..., None, :]  # columns scaled: M = R @ diag(s)
    return torch.einsum("...ij,...kj->...ik", M, M)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) wxyz unit quaternions.

    Branch-free Shepperd-style extraction: four candidates, each valid when
    its pivot is the largest, selected elementwise."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 0.5

    s0 = pivot(1.0 + tr)
    q0 = torch.stack([s0, (m21 - m12) / (4.0 * s0), (m02 - m20) / (4.0 * s0),
                      (m10 - m01) / (4.0 * s0)], dim=-1)
    s1 = pivot(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4.0 * s1), s1, (m01 + m10) / (4.0 * s1),
                      (m02 + m20) / (4.0 * s1)], dim=-1)
    s2 = pivot(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4.0 * s2), (m01 + m10) / (4.0 * s2), s2,
                      (m12 + m21) / (4.0 * s2)], dim=-1)
    s3 = pivot(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4.0 * s3), (m02 + m20) / (4.0 * s3),
                      (m12 + m21) / (4.0 * s3), s3], dim=-1)

    use0 = tr > 0.0
    use1 = (m00 >= m11) & (m00 >= m22) & ~use0
    use2 = (m11 > m00) & (m11 >= m22) & ~use0
    q = torch.where(use0[..., None], q0,
                    torch.where(use1[..., None], q1,
                                torch.where(use2[..., None], q2, q3)))
    return normalize(q)


def random_quats(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform random unit quaternions, shape (*shape, 4), drawn on the
    generator's device."""
    q = torch.randn(tuple(shape) + (4,), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return normalize(q)
