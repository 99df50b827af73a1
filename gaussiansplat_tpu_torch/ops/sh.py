"""Real spherical harmonics colour evaluation, degrees 0..3.

Per-gaussian evaluation with the direction from the camera centre to the
gaussian mean, the standard hard-coded basis constants, and the +0.5 offset
with a clamp at zero. Coefficients are stored FLAT, (N, 3K) with K =
(degree+1)^2, in [band0 rgb, band1 rgb, ...] order (the INRIA (K, 3) layout
reshaped).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of unit directions (..., 3) -> (..., K)."""
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        comps += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        comps += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Band-major (..., K_total, 3) SH coefficients -> RGB (..., 3), clamped
    >= 0. `dirs` need not be normalized; coefficients beyond degree are
    ignored (progressive SH-degree training with a fixed buffer)."""
    k = num_sh_coeffs(degree)
    d = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = sh_basis(d, degree)  # (..., k)
    rgb = torch.sum(basis[..., :, None] * sh[..., :k, :], dim=-2) + 0.5
    return torch.clamp(rgb, min=0.0)


def eval_sh_flat(sh_flat: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """FLAT (N, 3*K_total) SH coefficients -> RGB (N, 3), clamped >= 0.

    `dirs` need not be normalized; coefficients beyond degree are ignored."""
    k = num_sh_coeffs(degree)
    d = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = sh_basis(d, degree)  # (N, k)
    rgb = torch.zeros(sh_flat.shape[:-1] + (3,), dtype=sh_flat.dtype,
                      device=sh_flat.device)
    for i in range(k):
        rgb = rgb + basis[..., i : i + 1] * sh_flat[..., 3 * i : 3 * i + 3]
    return torch.clamp(rgb + 0.5, min=0.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """Invert the DC band: rgb in [0, 1] -> DC coefficient."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * SH_C0 + 0.5
