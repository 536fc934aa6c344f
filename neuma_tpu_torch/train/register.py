"""Stage-1 registration for real captures: fit one Sim(3) that aligns the
static 3DGS reconstruction to the first video frame of every view.

Counterpart of ``neuma_tpu/train/register.py`` (``RegisterConfig``,
``init_sim3_params``, ``apply_sim3``, ``apply_sim3_points``,
``RegistrationResult``, ``register_gaussians``) and of the reference's
``Register`` module with ``experiments/regist.py``: a continuous 6D
rotation, a translation and a scale (register.py:27-33), each fitted by
its own RAdam on its own cosine schedule (``optax.multi_transform`` in
the JAX package: one step count and one rectification per leaf) against
the L1 (+ D-SSIM) photometric loss of the first frame in every view
(regist.py:138-194). Each view renders through K4 and its gradient
through K5.

The loop does not wait for the card between log points: the overflow
flags are OR-ed into a device bool and the loss is read only at
iteration 1 (overflow only), every ``log_every`` and the last.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.rotation import euler_to_rotmat, rot6d_to_rotmat, rotmat_to_rot6d
from ..render.camera import Camera
from ..render.gaussians import GaussianPack
from ..render.rasterize import RasterConfig, rasterize_with_aux
from ..render.transforms import transform_gaussians
from .grounding import PairBudgetOverflowError
from .losses import l1_loss, ssim
from .optim import RAdam, apply_updates
from .schedulers import cosine_decay_schedule

LEAVES = ("r", "t", "s")


@dataclasses.dataclass
class RegisterConfig:
    """The reference register cfg: INIT_R (degrees), INIT_T, INIT_S, one
    learning rate per leaf, the cosine schedule's alpha, lambda_dssim and
    the iteration count (also the schedule's length)."""

    init_r_deg: Sequence[float] = (0.0, 0.0, 0.0)
    init_t: Sequence[float] = (0.0, 0.0, 0.0)
    init_s: float = 1.0
    lr_r: float = 1e-3
    lr_t: float = 1e-3
    lr_s: float = 1e-3
    iterations: int = 20000
    lambda_dssim: float = 0.0
    learning_rate_alpha: float = 0.05


def init_sim3_params(cfg: RegisterConfig, device="cpu") -> dict:
    """{"r": (6,), "t": (3,), "s": (1,)} float32 on ``device``."""
    euler = torch.tensor(cfg.init_r_deg, dtype=torch.float32) * (math.pi / 180.0)
    return {
        "r": rotmat_to_rot6d(euler_to_rotmat(euler)).to(device),
        "t": torch.tensor(cfg.init_t, dtype=torch.float32).to(device),
        "s": torch.tensor([cfg.init_s], dtype=torch.float32).to(device),
    }


def apply_sim3(params: dict, pack: GaussianPack) -> GaussianPack:
    """Scale (about the pack's centroid), rotate (positions, quaternions
    and SH), translate (register.py:68-91)."""
    R = rot6d_to_rotmat(params["r"])
    return transform_gaussians(pack, R=R, t=params["t"], scale=params["s"][0])


def apply_sim3_points(params: dict, points: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """The fitted Sim(3) on bare particles (regist.py:208-247); ``origin``
    is the kernels' centroid the fit scaled about."""
    R = rot6d_to_rotmat(params["r"])
    p = params["s"][0] * (points - origin)
    return p @ R.T + params["t"][None, :]


@dataclasses.dataclass
class RegistrationResult:
    params: dict  # numpy "r" (6,), "t" (3,), "s" (1,)
    losses: List[float]  # at every log_every and the last iteration
    origin: np.ndarray  # (1, 3)


def register_gaussians(
    pack: GaussianPack,
    cameras: Sequence[Camera],
    gt_images: torch.Tensor,  # (n_views, 3, H, W) first-frame GT
    cfg: RegisterConfig,
    background: torch.Tensor,
    raster_cfg: RasterConfig = RasterConfig(),
    log_fn: Optional[Callable] = None,
    log_every: int = 500,
    device=None,
) -> RegistrationResult:
    """Fit the Sim(3) on ``device`` (``cuda`` unless the caller asks for
    the CPU). Raises ``PairBudgetOverflowError`` at the first log point
    after any view dropped pairs."""
    device = resolve_device(device)
    pack = pack.to(device)
    cameras = [c.to(device) for c in cameras]
    gt_images = torch.as_tensor(gt_images, dtype=torch.float32).to(device)
    background = torch.as_tensor(background, dtype=torch.float32).to(device)
    params = {k: v.requires_grad_(True) for k, v in init_sim3_params(cfg, device).items()}
    leaves = [params[k] for k in LEAVES]
    origin = torch.mean(pack.xyz, dim=0, keepdim=True)
    opts = [RAdam(cosine_decay_schedule(lr, cfg.iterations, cfg.learning_rate_alpha))
            for lr in (cfg.lr_r, cfg.lr_t, cfg.lr_s)]
    states = [opt.init([p]) for opt, p in zip(opts, leaves)]
    opacity = pack.get_opacity

    def loss_fn():
        moved = apply_sim3(params, pack)
        cov = moved.get_covariance()
        shs = moved.get_features
        loss, overflow = 0.0, torch.zeros((), dtype=torch.bool, device=device)
        for cam, gt in zip(cameras, gt_images):
            img, aux = rasterize_with_aux(moved.xyz, cov, opacity, cam, background, shs=shs,
                                          sh_degree=pack.sh_degree, cfg=raster_cfg)
            overflow = overflow | aux["overflow"]
            loss = loss + l1_loss(img, gt)
            if cfg.lambda_dssim > 0:
                loss = loss + cfg.lambda_dssim * (1.0 - ssim(img, gt))
        return loss, overflow

    losses = []
    ever_ovf = torch.zeros((), dtype=torch.bool, device=device)
    for it in range(1, cfg.iterations + 1):
        loss, overflow = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
        for i, (opt, g, p) in enumerate(zip(opts, grads, leaves)):
            updates, states[i] = opt.update([g], states[i], [p])
            apply_updates([p], updates)
        # OR-ed on the device, so an overflow between log points is kept.
        ever_ovf = ever_ovf | overflow
        log_point = it % log_every == 0 or it == cfg.iterations
        if (it == 1 or log_point) and bool(ever_ovf):
            raise PairBudgetOverflowError(
                f"raster pair budget exceeded by registration iter {it}:"
                " raise raster.max_pairs/max_per_tile"
            )
        if log_point:
            losses.append(float(loss.detach()))
            if log_fn:
                log_fn(it, losses[-1], {k: v.detach() for k, v in params.items()})
    return RegistrationResult(
        params={k: v.detach().cpu().numpy() for k, v in params.items()},
        losses=losses,
        origin=origin.cpu().numpy(),
    )
