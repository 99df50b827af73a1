"""Plain PyTorch reference of the 3DGS training step: L1 + DSSIM, its
gradients through reference/render.py, and Adam with the 3DGS learning
rates (Kerbl et al. 2023: per-group rates, the position rate decaying
exponentially from lr_means to lr_means_final over the run and scaled by
the scene extent; SSIM with an 11x11 gaussian window of sigma 1.5, zero
padding, C1 = 0.01^2, C2 = 0.03^2). Every value comes from the cell's
configuration file.

`follow` takes the initial parameters the benchmark made, runs the steps
and returns what the comparison reads: each step's loss, the norm of each
leaf's first gradient, each leaf's change after the steps, and each
step's raster counts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

LEAVES = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


def _window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    xs = np.arange(size) - (size - 1) / 2.0
    w = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return torch.tensor((w / w.sum()).astype(np.float32))


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W), zero padding."""
    w = _window().to(x.device)
    y = F.conv2d(x[:, None], w.view(1, 1, 11, 1), padding=(5, 0))
    return F.conv2d(y, w.view(1, 1, 1, 11), padding=(0, 5))[:, 0]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of (H, W, C) images."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    h, w, c = a.shape
    st = torch.stack([a, b, a * a, b * b, a * b]).permute(0, 3, 1, 2)
    mu_a, mu_b, e_aa, e_bb, e_ab = _blur(st.reshape(5 * c, h, w)).reshape(
        5, c, h, w).unbind(0)
    s_aa = e_aa - mu_a * mu_a
    s_bb = e_bb - mu_b * mu_b
    s_ab = e_ab - mu_a * mu_b
    m = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2))
    return m.mean()


def loss_fn(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    """(1 - lam) L1 + lam (1 - SSIM)."""
    return (1 - lam) * (img - gt).abs().mean() + lam * (1 - ssim(img, gt))


def position_lr(train: dict, extent: float, step: int) -> float:
    t = min(max(step / train["iterations"], 0.0), 1.0)
    lo = math.log(train["lr_means"] * extent)
    hi = math.log(train["lr_means_final"] * extent)
    return math.exp(lo * (1 - t) + hi * t)


def extent_of(means: torch.Tensor, alive: torch.Tensor) -> float:
    """Radius of the bounding sphere of the alive centres about their mean."""
    m = means[alive]
    return float(torch.linalg.vector_norm(m - m.mean(0), dim=-1).max())


def follow(params0: Dict[str, torch.Tensor], alive: torch.Tensor, views,
           rc: R.Raster, train: dict, sh_degree: int, extent: float,
           steps: int, payload_dtype: Optional[torch.dtype] = None,
           half_batch: bool = False, count: bool = False) -> dict:
    """`steps` training steps from params0 over `views` [(Camera, target,
    background)]. `payload_dtype` rounds the raster fields (the control);
    `half_batch` takes the loss over the top half of the rows (a fault);
    `count` keeps each step's RasterCounts."""
    p = {k: params0[k].detach().clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = train["beta1"], train["beta2"], train["adam_eps"]
    lrs = dict(quats=train["lr_quats"], log_scales=train["lr_scales"],
               logit_opacities=train["lr_opacities"], sh_dc=train["lr_sh_dc"],
               sh_rest=train["lr_sh_rest"])
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    counts = []
    with R.fp32_math():
        for i in range(steps):
            cam, gt, bg = views[i]
            leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            proj = R.project(leaves, alive, cam, rc, sh_degree)
            fields = R.round_fields(proj["fields"], payload_dtype)
            img, _, cnt = R.render(proj, cam, rc, bg, count=count,
                                   fields=fields)
            counts.append(cnt)
            img = img.requires_grad_(True)
            rows = img.shape[0] // 2 if half_batch else img.shape[0]
            loss = loss_fn(img[:rows], gt[:rows], train["ssim_lambda"])
            (dimg,) = torch.autograd.grad(loss, img)
            loss = loss.detach()
            dfields = R.raster_backward(proj, fields, cam, rc, dimg, bg)
            grads = torch.autograd.grad(fields, list(leaves.values()),
                                        grad_outputs=dfields, allow_unused=True)
            losses.append(loss.item())
            g = {k: torch.zeros_like(p[k]) if d is None else d
                 for k, d in zip(leaves, grads)}
            if i == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g[k]))
                              for k in LEAVES}
            t = i + 1
            with torch.no_grad():
                for k in LEAVES:
                    lr = position_lr(train, extent, i) if k == "means" else lrs[k]
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            del leaves, proj, fields, img, dimg, dfields, grads, g
    change = {k: float(torch.linalg.vector_norm(p[k] - params0[k]))
              for k in LEAVES}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                counts=counts)
