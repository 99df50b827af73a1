"""Scene and camera generators of the benchmark, drawn from the seed.

- `bench_scene`: the reference package's bench scene (bench.py, and
  chip_smoke.bench_scene in the port): centres uniform in [-1, 1]^3,
  random unit quaternions, log-uniform per-axis scales in
  (0.004 k, 0.012 k) with k = (1600 / fx) sqrt(W H / n / 2.0736), opacity
  0.8, base colours uniform in (0.05, 0.95) in the DC band. Drawn on the
  device with one torch.Generator in a few large calls. The higher SH bands
  are N(0, sh_rest_std^2) (the bench scene's are zero) so that the
  view-dependent colour carries signal.
- `quality_scene`: a copy of the port's data/benchmark.py generator (the
  procedural 150k-gaussian ground truth: ground disk, banded sphere, box,
  striped torus, cone, surface-aligned flat splats, a Phong lobe projected
  on SH 1-3 of the sphere and torus) and of its initial cloud (a noisy
  grey subsample of the surfaces; scales from the mean squared distance to
  the three nearest neighbours, as 3DGS initializes from SfM points).
  numpy generators seeded from `seed`, drawn in a fixed order.
- Cameras: `look_at` (rows of R are right, true-up and forward; +z looks
  forward), orbits and the hemisphere spiral of data/benchmark.py.
  Principal points at ((W - 1) / 2, (H - 1) / 2).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .render import SH_C0, sh_basis

F32 = torch.float32


def look_at(eye, target, up):
    """World-to-camera (R, t) as float32 arrays."""
    eye, target, up = (np.asarray(a, np.float64) for a in (eye, target, up))
    w = target - eye
    w /= np.linalg.norm(w)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    rot = np.stack([u, v, w])
    return rot.astype(np.float32), (-rot @ eye).astype(np.float32)


def orbit_eye(angle: float, elevation: float, radius: float):
    return (radius * math.cos(elevation) * math.sin(angle),
            radius * math.sin(elevation),
            radius * math.cos(elevation) * math.cos(angle))


def hemisphere_eyes(count: int, radius: float = 4.4):
    """data/benchmark.py's spiral over the upper hemisphere (three loops,
    elevation 0.15 -> 1.2 rad); its cameras look at (0, 0.45, 0) with up
    (0, -1, 0) and fx = 1.25 W."""
    eyes = []
    for i in range(count):
        t = i / count
        az = 2 * math.pi * (t * 3.0)
        el = 0.15 + 1.05 * t
        eyes.append((radius * math.cos(el) * math.cos(az),
                     radius * math.sin(el), radius * math.cos(el) * math.sin(az)))
    return eyes


def _random_quats(g: torch.Generator, n: int, device) -> torch.Tensor:
    q = torch.randn((n, 4), generator=g, device=device, dtype=F32)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def bench_scene(seed: int, n: int, sh_degree: int, opacity: float,
                scale_range, width: int, height: int, fx: float,
                sh_rest_std: float, device) -> Tuple[Dict, torch.Tensor]:
    """Parameters (dict of (n, ...) float32) and the alive mask."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k = (1600.0 / fx) * ((width * height / n) / 2.0736) ** 0.5
    lo, hi = math.log(scale_range[0] * k), math.log(scale_range[1] * k)
    kw = dict(generator=g, device=device, dtype=F32)
    means = torch.rand((n, 3), **kw) * 2.0 - 1.0
    quats = _random_quats(g, n, device)
    log_scales = lo + torch.rand((n, 3), **kw) * (hi - lo)
    colors = 0.05 + torch.rand((n, 3), **kw) * 0.9
    rest = 3 * ((sh_degree + 1) ** 2 - 1)
    params = dict(
        means=means, quats=quats, log_scales=log_scales,
        logit_opacities=torch.full((n,), math.log(opacity / (1 - opacity)),
                                   dtype=F32, device=device),
        sh_dc=(colors - 0.5) / SH_C0,
        sh_rest=sh_rest_std * torch.randn((n, rest), **kw),
    )
    return params, torch.ones((n,), dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# The quality scene: a copy of data/benchmark.py's generator.

def _checker(u, v, size=0.4):
    return ((np.floor(u / size) + np.floor(v / size)) % 2.0).astype(np.float32)


def _sample_surfaces(n: int, rng: np.random.Generator):
    """~n points over the five objects: (points, normals, colours, ids)."""
    frac = np.array([0.34, 0.16, 0.18, 0.18, 0.14])
    counts = (frac * n).astype(int)
    counts[0] += n - counts.sum()
    pts, nrm, col = [], [], []

    m = counts[0]                                       # ground disk
    r = 2.4 * np.sqrt(rng.random(m, dtype=np.float32))
    th = 2 * np.pi * rng.random(m, dtype=np.float32)
    x, z = r * np.cos(th), r * np.sin(th)
    pts.append(np.stack([x, np.zeros_like(x), z], -1))
    nrm.append(np.tile([0.0, 1.0, 0.0], (m, 1)).astype(np.float32))
    c = _checker(x, z, size=0.15)
    col.append(np.stack([0.25 + 0.55 * c, 0.25 + 0.45 * c, 0.45 + 0.3 * c], -1))

    m = counts[1]                                       # sphere
    u = rng.random(m, dtype=np.float32)
    v = rng.random(m, dtype=np.float32)
    phi, cth = 2 * np.pi * u, 2 * v - 1
    sth = np.sqrt(np.maximum(1 - cth ** 2, 0))
    nn = np.stack([sth * np.cos(phi), cth, sth * np.sin(phi)], -1)
    pts.append(np.array([-0.9, 0.55, -0.3], np.float32) + 0.55 * nn)
    nrm.append(nn.astype(np.float32))
    band = (np.floor((cth + 1) * 6.0) % 2.0).astype(np.float32)
    col.append(np.stack([0.85 - 0.6 * band, 0.2 + 0.5 * band,
                         0.25 + 0.2 * band], -1))

    m = counts[2]                                       # box
    face = rng.integers(0, 6, m)
    ax, sgn = face // 2, (face % 2) * 2.0 - 1.0
    uv = rng.random((m, 2), dtype=np.float32) - 0.5
    p = np.zeros((m, 3), np.float32)
    nl = np.zeros((m, 3), np.float32)
    for a in range(3):
        sel = ax == a
        o1, o2 = (a + 1) % 3, (a + 2) % 3
        p[sel, a] = 0.5 * sgn[sel]
        p[sel, o1] = uv[sel, 0]
        p[sel, o2] = uv[sel, 1]
        nl[sel, a] = sgn[sel]
    ca, sa = math.cos(0.5236), math.sin(0.5236)
    rot = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], np.float32)
    p = 0.7 * p @ rot.T + np.array([0.85, 0.35, -0.45], np.float32)
    nl = nl @ rot.T
    pts.append(p)
    nrm.append(nl)
    palette = np.array(
        [[0.9, 0.25, 0.2], [0.95, 0.7, 0.1], [0.2, 0.65, 0.3],
         [0.15, 0.45, 0.85], [0.85, 0.85, 0.85], [0.55, 0.25, 0.7]],
        np.float32)
    chk = _checker(uv[:, 0] + 0.5, uv[:, 1] + 0.5, size=0.125)
    col.append(palette[face] * (0.7 + 0.3 * chk[:, None]))

    m = counts[3]                                       # torus
    a1 = 2 * np.pi * rng.random(m, dtype=np.float32)
    a2 = 2 * np.pi * rng.random(m, dtype=np.float32)
    cx = np.stack([0.55 * np.cos(a1), np.zeros(m, np.float32),
                   0.55 * np.sin(a1)], -1)
    nn = np.stack([np.cos(a2) * np.cos(a1), np.sin(a2),
                   np.cos(a2) * np.sin(a1)], -1).astype(np.float32)
    pts.append(np.array([0.1, 0.22, 0.9], np.float32) + cx + 0.18 * nn)
    nrm.append(nn)
    stripe = (np.floor(a1 / (np.pi / 8)) % 2.0).astype(np.float32)
    col.append(np.stack([0.2 + 0.7 * stripe, 0.8 - 0.5 * stripe,
                         np.full(m, 0.75, np.float32)], -1))

    m = counts[4]                                       # cone
    t = np.sqrt(rng.random(m, dtype=np.float32))
    a = 2 * np.pi * rng.random(m, dtype=np.float32)
    rr = 0.4 * (1 - t)
    p = np.stack([rr * np.cos(a) - 0.2, 1.1 * t, rr * np.sin(a) + 0.1], -1)
    nl = np.stack([np.cos(a), np.full(m, 0.4 / 1.1, np.float32), np.sin(a)], -1)
    nl /= np.linalg.norm(nl, axis=-1, keepdims=True)
    pts.append(p.astype(np.float32))
    nrm.append(nl.astype(np.float32))
    col.append(np.stack([0.95 - 0.5 * t, 0.4 + 0.5 * t,
                         0.15 + 0.2 * np.cos(3 * a) ** 2], -1))

    obj_id = np.concatenate(
        [np.full(c, i, np.int32) for i, c in enumerate(counts)])
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nrm).astype(np.float32),
            np.clip(np.concatenate(col), 0.02, 0.98).astype(np.float32),
            obj_id)


def _specular_sh_rest(normals: np.ndarray, sh_degree: int,
                      light_dir=(0.4, 0.75, 0.5), power: float = 8.0,
                      strength: float = 0.45) -> np.ndarray:
    """A Phong lobe strength max(a . d, 0)^power about the mirror axis of
    the light, projected on the rest bands (zonal-harmonic weights by
    Gauss-Legendre): (N, (deg + 1)^2 - 1, 3)."""
    from numpy.polynomial import legendre as L

    lv = np.asarray(light_dir, np.float32)
    lv /= np.linalg.norm(lv)
    ndl = normals @ lv
    axis = -(2.0 * ndl[:, None] * normals - lv[None, :])
    axis /= np.maximum(np.linalg.norm(axis, axis=-1, keepdims=True), 1e-12)
    t, gw = L.leggauss(64)
    f = np.clip(t, 0.0, None) ** power
    w = [2.0 * np.pi * np.sum(gw * f * L.legval(t, [0] * l + [1]))
         for l in range(sh_degree + 1)]
    basis = sh_basis(torch.as_tensor(axis), sh_degree).numpy()
    k = (sh_degree + 1) ** 2
    band_of = np.concatenate([np.full(2 * l + 1, l) for l in range(sh_degree + 1)])
    coeffs = basis * np.array([w[l] for l in band_of], np.float32)[None, :]
    return (strength * coeffs[:, 1:k, None]
            * np.ones((1, 1, 3), np.float32)).astype(np.float32)


def _quat_from_normal(n: np.ndarray) -> np.ndarray:
    w = 1.0 + n[:, 2]
    q = np.stack([w, -n[:, 1], n[:, 0], np.zeros_like(w)], -1)
    q[w < 1e-6] = [0.0, 1.0, 0.0, 0.0]
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _params(device, **arrays) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in arrays.items()}


def quality_gt(seed: int, n_points: int, sh_degree: int, device):
    """The ground-truth gaussians (all alive)."""
    rng = np.random.default_rng(seed)
    pts, nrm, col, obj_id = _sample_surfaces(n_points, rng)
    n = pts.shape[0]
    spacing = math.sqrt(4.0 * math.pi / n)
    tangent = spacing * (1.4 + 0.4 * rng.random(n, dtype=np.float32))
    log_scales = np.stack([np.log(tangent), np.log(tangent),
                           np.log(tangent / 6.0)], -1)
    op = 0.92 + 0.06 * rng.random(n, dtype=np.float32)
    k = (sh_degree + 1) ** 2
    sh_rest = (0.04 * rng.standard_normal((n, k - 1, 3))).astype(np.float32)
    shiny = np.isin(obj_id, np.asarray((1, 3)))
    sh_rest = sh_rest + np.where(shiny[:, None, None],
                                 _specular_sh_rest(nrm, sh_degree), 0.0)
    params = _params(device, means=pts, quats=_quat_from_normal(nrm),
                     log_scales=log_scales,
                     logit_opacities=np.log(op / (1 - op)),
                     sh_dc=(col - 0.5) / SH_C0,
                     sh_rest=sh_rest.reshape(n, -1))
    return params, torch.ones((n,), dtype=torch.bool, device=device)


def quality_init(seed: int, init_points: int, capacity: int, sh_degree: int,
                 init_opacity: float, device):
    """The initial cloud at `capacity` slots, the first init_points alive:
    centres with N(0, 0.02^2) noise, colours 0.5 c + 0.25, isotropic scale
    the root of the mean squared distance to the 3 nearest other points,
    identity rotation, opacity init_opacity, zero rest bands."""
    rng = np.random.default_rng(seed + 1)
    pts, _, col, _ = _sample_surfaces(init_points, rng)
    pts = pts + 0.02 * rng.standard_normal(pts.shape).astype(np.float32)
    col = 0.5 * col + 0.25
    p = torch.as_tensor(pts).to(device)
    d2 = torch.empty((init_points,), dtype=F32, device=device)
    for s in range(0, init_points, 2048):
        block = torch.cdist(p[s:s + 2048], p).square()
        d2[s:s + 2048] = torch.topk(block, 4, dim=1, largest=False).values[:, 1:].mean(1)
    log_s = torch.log(torch.sqrt(torch.clamp(d2, min=1e-7)))
    k = (sh_degree + 1) ** 2
    params = {
        "means": torch.zeros((capacity, 3), dtype=F32, device=device),
        "quats": torch.zeros((capacity, 4), dtype=F32, device=device),
        "log_scales": torch.full((capacity, 3), -10.0, dtype=F32, device=device),
        "logit_opacities": torch.full((capacity,), -10.0, dtype=F32, device=device),
        "sh_dc": torch.zeros((capacity, 3), dtype=F32, device=device),
        "sh_rest": torch.zeros((capacity, 3 * (k - 1)), dtype=F32, device=device),
    }
    params["quats"][:, 0] = 1.0
    n = init_points
    params["means"][:n] = p
    params["log_scales"][:n] = log_s[:, None]
    params["logit_opacities"][:n] = math.log(init_opacity / (1 - init_opacity))
    params["sh_dc"][:n] = (torch.as_tensor(col).to(device) - 0.5) / SH_C0
    alive = torch.zeros((capacity,), dtype=torch.bool, device=device)
    alive[:n] = True
    return params, alive
