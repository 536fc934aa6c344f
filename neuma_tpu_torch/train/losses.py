"""Image losses and metrics.

Counterpart of ``neuma_tpu/train/losses.py`` (``l1_loss``, ``l2_loss``,
``smooth_l1_loss``, ``mse``, ``psnr``, ``_gaussian_window``, ``ssim``):
the reference's l1/l2/smooth-l1, windowed SSIM with an 11-tap sigma-1.5
Gaussian window, and mse/psnr.

``ssim`` forms its local statistics in float64 and returns the input's
dtype. In float32, sigma^2 = E[x^2] - E[x]^2 cancels where an image is
flat (a uniform background): the card and the CPU, which sum the 121
window taps in other orders, then differed by 2e-5 relative on 800x800
renders. Its depthwise convolution (``window_conv``) runs its forward
and its input gradient under ``exact_conv``: cuDNN with TF32 off and
deterministic algorithms, so the registration's D-SSIM gradient repeats
bit for bit. The global flags are restored on exit; the backward sets
them again itself, since autograd runs it after the forward's context
has closed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def smooth_l1_loss(pred: torch.Tensor, gt: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - gt)
    return torch.mean(torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean over the last three axes (C, H, W)."""
    return torch.mean((a - b) ** 2, dim=(-3, -2, -1))


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """``inf`` for identical images, as in the JAX package."""
    return 20.0 * torch.log10(data_range / torch.sqrt(mse(a, b)))


def exact_conv():
    """Context for the metric convolutions: cuDNN without TF32 and with
    deterministic algorithms (both forward and backward)."""
    return torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False)


def _gaussian_window(window_size: int, sigma: float, device=None) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32, device=device)
    g = torch.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


class _WindowConv(torch.autograd.Function):
    """Depthwise SAME convolution by a constant window, differentiable in
    its input only."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(kernel)
        ctx.shape = x.shape
        with exact_conv():
            return F.conv2d(x, kernel, padding=kernel.shape[-1] // 2, groups=x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        (kernel,) = ctx.saved_tensors
        with exact_conv():
            dx = torch.nn.grad.conv2d_input(ctx.shape, kernel, dy, padding=kernel.shape[-1] // 2,
                                            groups=ctx.shape[1])
        return dx, None


def window_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) by a (C, 1, k, k) window, zero padded to the same size."""
    return _WindowConv.apply(x, kernel)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Windowed SSIM over (C, H, W) or (N, C, H, W) images: per-channel
    convolution with SAME (zero) padding, C1 = 0.01^2, C2 = 0.03^2; the
    statistics in float64 (the window is the float32 one)."""
    dtype = img1.dtype
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    img1, img2 = img1.double(), img2.double()
    g = _gaussian_window(window_size, sigma, img1.device)
    c = img1.shape[1]
    kernel = torch.outer(g, g).double()[None, None].repeat(c, 1, 1, 1)  # depthwise (C, 1, W, W)

    mu1, mu2 = window_conv(img1, kernel), window_conv(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = window_conv(img1 * img1, kernel) - mu1_sq
    sigma2_sq = window_conv(img2 * img2, kernel) - mu2_sq
    sigma12 = window_conv(img1 * img2, kernel) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map).to(dtype)
