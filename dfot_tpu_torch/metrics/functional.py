"""Frame-wise metrics on tensors: MSE, PSNR, SSIM.

Port of ``dfot_tpu/metrics/functional.py`` (:16-60). Videos are (B, T, H,
W, C) in [0, 1]; each function returns (B, T). SSIM's Gaussian window is a
depthwise ``conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mse", "psnr", "ssim"]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame MSE: (B, T, H, W, C) -> (B, T)."""
    return ((pred - target) ** 2).mean(dim=(-1, -2, -3))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    m = mse(pred, target)
    return 10.0 * torch.log10(data_range**2 / m.clamp(min=1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Per-frame SSIM with a Gaussian window (valid padding): (B, T, H, W,
    C) -> (B, T)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    B, T, H, W, C = pred.shape
    x = pred.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    y = target.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    kern = _gaussian_kernel(kernel_size, sigma, pred.device).to(pred.dtype)
    kern = kern.expand(C, 1, kernel_size, kernel_size)

    def filt(v):
        return F.conv2d(v, kern, groups=C)

    mu_x, mu_y = filt(x), filt(y)
    sxx = filt(x * x) - mu_x**2
    syy = filt(y * y) - mu_y**2
    sxy = filt(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2)
    return (num / den).reshape(B, T, -1).mean(dim=-1)
