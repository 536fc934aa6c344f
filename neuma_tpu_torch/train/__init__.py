"""Grounding losses and rollout (counterpart of ``neuma_tpu/train``)."""
from .losses import l1_loss, l2_loss, mse, psnr, smooth_l1_loss, ssim
from .optim import clip_by_global_norm_strict, masked_radam, radam
from .schedulers import cosine_decay_schedule, exponential_decay_schedule, fetch_schedule

__all__ = [
    "l1_loss",
    "l2_loss",
    "smooth_l1_loss",
    "ssim",
    "psnr",
    "mse",
    "cosine_decay_schedule",
    "exponential_decay_schedule",
    "fetch_schedule",
    "radam",
    "clip_by_global_norm_strict",
    "masked_radam",
]
