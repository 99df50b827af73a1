"""Training losses: L1 + lambda * DSSIM (the standard 3DGS objective).

SSIM with a separable 11x11 gaussian window (sigma 1.5), zero padding at
the borders ('SAME'), and the usual C1 = 0.01^2, C2 = 0.03^2 stabilizers.
The reference blurs with banded Toeplitz matmuls, a choice made for the
TPU's matrix unit; here the blur is a depthwise conv2d per axis, which
computes the same sums in another order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_WINDOW = 11
_SIGMA = 1.5


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int = _WINDOW, sigma: float = _SIGMA) -> tuple:
    xs = np.arange(size) - (size - 1) / 2.0
    w = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    w /= w.sum()
    return tuple(w.astype(np.float32))


def _blur_f32(x: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W) with zero padding: a (11, 1)
    then a (1, 11) conv2d. cuDNN would run these f32 convolutions in TF32
    by default (torch.backends.cudnn.allow_tf32 is True), which keeps ~3
    decimal digits; the flag is pinned to False here, whatever the caller
    set, and restored after."""
    w = torch.tensor(_gaussian_window(), dtype=torch.float32, device=x.device)
    half = (_WINDOW - 1) // 2
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x[:, None], w.view(1, 1, _WINDOW, 1), padding=(half, 0))
        y = F.conv2d(y, w.view(1, 1, 1, _WINDOW), padding=(0, half))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y[:, 0]


class _Blur(torch.autograd.Function):
    """The blur is linear and, with a symmetric window and zero padding,
    its own adjoint: the backward is the same pinned-f32 blur, so the
    gradient is full f32 too."""

    @staticmethod
    def forward(ctx, x):
        return _blur_f32(x)

    @staticmethod
    def backward(ctx, g):
        return _blur_f32(g.contiguous())


def ssim_map(
    img_a: torch.Tensor,
    img_b: torch.Tensor,
    c1: float = 0.01 ** 2,
    c2: float = 0.03 ** 2,
) -> torch.Tensor:
    """Per-pixel SSIM map (H, W, C) of images in [0, 1]. Windows at image
    borders see zero padding. The five blurs run as one batched blur,
    always in full f32 (see `_blur_f32`)."""
    h, w, c = img_a.shape
    stack = torch.stack([img_a, img_b, img_a * img_a, img_b * img_b,
                         img_a * img_b])                      # (5, H, W, C)
    blurred = _Blur.apply(stack.permute(0, 3, 1, 2).reshape(5 * c, h, w))
    mu_a, mu_b, e_aa, e_bb, e_ab = blurred.reshape(5, c, h, w).permute(
        0, 2, 3, 1).unbind(0)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = e_aa - mu_aa
    sigma_bb = e_bb - mu_bb
    sigma_ab = e_ab - mu_ab
    return ((2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))


def ssim(img_a: torch.Tensor, img_b: torch.Tensor, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM over (H, W, C) images in [0, 1]."""
    return ssim_map(img_a, img_b, c1, c2).mean()


def l1(img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    return (img_a - img_b).abs().mean()


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     ssim_lambda: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM), the 3DGS training objective."""
    return (1.0 - ssim_lambda) * l1(pred, gt) + ssim_lambda * (1.0 - ssim(pred, gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))
