"""The gaussian scene model: a fixed-capacity `nn.Module` with an alive mask.

Parameterization (standard 3DGS, applied at projection time):
  means           (C, 3)        world positions
  quats           (C, 4)        wxyz rotations, unnormalized
  log_scales      (C, 3)        log standard deviations
  logit_opacities (C,)          pre-sigmoid opacity
  sh_dc           (C, 3)        DC spherical-harmonics band  (PLY f_dc_*)
  sh_rest         (C, 3*(K-1))  higher SH bands, FLAT        (PLY f_rest_*)
plus the boolean buffer `alive` (C,). The SH order within a row is
[band0 rgb, band1 rgb, ...], the (K, 3) INRIA layout reshaped.

Entry points put the tensors on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.quaternion import random_quats
from ..ops.sh import num_sh_coeffs, rgb_to_sh_dc

PARAM_NAMES = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
               "sh_rest")


class GaussianModel(nn.Module):
    def __init__(self, means, quats, log_scales, logit_opacities, sh_dc,
                 sh_rest, alive):
        super().__init__()
        self.means = nn.Parameter(means)
        self.quats = nn.Parameter(quats)
        self.log_scales = nn.Parameter(log_scales)
        self.logit_opacities = nn.Parameter(logit_opacities)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def sh_degree(self) -> int:
        return int(round((self.sh_rest.shape[1] // 3 + 1) ** 0.5)) - 1

    @property
    def num_alive(self) -> torch.Tensor:
        """() int32 number of alive slots (stays on the device)."""
        return self.alive.sum(dtype=torch.int32)

    @property
    def sh(self) -> torch.Tensor:
        """FLAT (C, 3K) SH coefficients."""
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The optimizer-visible parameter groups (alive mask excluded)."""
        return {k: getattr(self, k) for k in PARAM_NAMES}


def empty_model(capacity: int, sh_degree: int = 3, device="cuda") -> GaussianModel:
    k = num_sh_coeffs(sh_degree)
    kw = dict(dtype=torch.float32, device=device)
    quats = torch.zeros((capacity, 4), **kw)
    quats[:, 0] = 1.0
    return GaussianModel(
        means=torch.zeros((capacity, 3), **kw),
        quats=quats,
        log_scales=torch.full((capacity, 3), -10.0, **kw),
        logit_opacities=torch.full((capacity,), -10.0, **kw),
        sh_dc=torch.zeros((capacity, 3), **kw),
        sh_rest=torch.zeros((capacity, 3 * (k - 1)), **kw),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _fill(model: GaussianModel, n: int, **values: torch.Tensor) -> GaussianModel:
    with torch.no_grad():
        for name, v in values.items():
            getattr(model, name)[:n] = v.to(model.device, torch.float32)
        model.alive[:n] = True
    return model


def random_model(
    generator: torch.Generator,
    n: int,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    extent: float = 1.0,
    opacity: float = 0.8,
    scale_range: Tuple[float, float] = (0.02, 0.08),
    device="cuda",
) -> GaussianModel:
    """Random scene for tests and benchmarks. Draws on the generator's
    device, then moves the tensors to `device`."""
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    means = (torch.rand((n, 3), **kw) * 2.0 - 1.0) * extent
    quats = random_quats(generator, (n,))
    lo = math.log(scale_range[0] * extent)
    hi = math.log(scale_range[1] * extent)
    log_scales = lo + torch.rand((n, 3), **kw) * (hi - lo)
    colors = 0.05 + torch.rand((n, 3), **kw) * 0.9
    logit_op = torch.full((n,), math.log(opacity / (1 - opacity)))
    return _fill(
        empty_model(capacity, sh_degree, device), n,
        means=means, quats=quats, log_scales=log_scales,
        logit_opacities=logit_op, sh_dc=rgb_to_sh_dc(colors),
    )


def from_arrays(
    means: np.ndarray,
    quats: np.ndarray,
    log_scales: np.ndarray,
    logit_opacities: np.ndarray,
    sh_dc: np.ndarray,
    sh_rest: np.ndarray,
    capacity: Optional[int] = None,
    device="cuda",
) -> GaussianModel:
    """Build a model from host arrays (e.g. a parsed INRIA PLY). SH arrays
    may be band-major (N, K, 3) or flat (N, 3K); both are stored flat."""
    n = means.shape[0]
    sh_dc = np.asarray(sh_dc, np.float32).reshape(n, -1)
    sh_rest = np.asarray(sh_rest, np.float32).reshape(n, -1)
    k = 1 + sh_rest.shape[1] // 3
    deg = int(round(k ** 0.5)) - 1
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return _fill(
        empty_model(capacity, deg, device), n,
        means=t(means), quats=t(quats), log_scales=t(log_scales),
        logit_opacities=t(logit_opacities), sh_dc=t(sh_dc), sh_rest=t(sh_rest),
    )


def _next_pow2(x: int) -> int:
    p = 1
    while p < max(x, 1):
        p *= 2
    return p


def from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: Optional[int] = None,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    device="cuda",
) -> GaussianModel:
    """Initialize from an SfM point cloud, 3DGS-style: isotropic scale from
    the mean squared distance to the 3 nearest neighbours (numpy, on the
    host, chunked O(n^2)). The capacity defaults to the next power of two
    of 4n."""
    n = points.shape[0]
    pts = np.asarray(points, np.float32)
    d2mean = np.empty((n,), np.float32)
    chunk = 2048
    for s in range(0, n, chunk):
        block = pts[s : s + chunk]
        d2 = ((block[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        d2.partition(3, axis=1)
        d2mean[s : s + chunk] = np.maximum(d2[:, 1:4].mean(1), 1e-7)
    scales = np.log(np.sqrt(d2mean))[:, None].repeat(3, axis=1)

    k = num_sh_coeffs(sh_degree)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    logit_op = np.full((n,), float(np.log(init_opacity / (1 - init_opacity))),
                       np.float32)
    sh_dc = rgb_to_sh_dc(torch.as_tensor(np.asarray(colors, np.float32)))
    sh_dc = sh_dc.numpy()[:, None, :]
    sh_rest = np.zeros((n, k - 1, 3), np.float32)
    capacity = capacity or _next_pow2(4 * n)
    return from_arrays(pts, quats, scales, logit_op, sh_dc, sh_rest, capacity,
                       device=device)


def from_numpy_params(params: Dict[str, np.ndarray], alive: np.ndarray,
                      device="cuda") -> GaussianModel:
    """A model holding exactly the given parameter arrays and alive mask,
    e.g. a reference-package model's `trainable()` and `alive` passed
    through `np.asarray` (dead slots included)."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32, copy=True)).to(device)
    return GaussianModel(
        **{k: t(params[k]) for k in PARAM_NAMES},
        alive=torch.as_tensor(np.array(alive, bool, copy=True)).to(device),
    )


def scene_extent(model: GaussianModel) -> torch.Tensor:
    """Radius of the bounding sphere of the alive gaussian centres."""
    with torch.no_grad():
        w = model.alive.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        center = (model.means * w[:, None]).sum(0) / denom
        d = torch.linalg.vector_norm(model.means - center, dim=-1) * w
        return d.max()
