"""Dynamics grounding CLI: two-stage training (initial velocity, then LoRA
constitutive laws) from a config, on the card.

Counterpart of ``neuma_tpu/apps/finetune.py`` (``parse_args``, ``main``)
and of the reference's ``experiments/finetune.py``. Usage:

    python -m neuma_tpu_torch.apps.finetune -c configs/synthetic/finetune-bb.yaml \\
        [--set key.path=value ...]

It prepares the simulation data (idempotent), runs stage 1 (or reloads
``finetune/init.npz``) and stage 2, and writes ``config.yaml``,
``log.txt``, ``metrics.jsonl``, ``finetune/init.npz``, the
``finetune/*_lora.npz`` ring and ``finetune/train_state.npz``. With
``resume=true`` stage 2 restores the full train state when that file
exists, else the newest LoRA weights with a cold optimizer.

``main(argv, device)`` runs on ``cuda`` unless ``device="cpu"`` is
passed; without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.readers import VideoDataset
from ..parallel.distributed import initialize, is_primary
from ..train.checkpoint import MetricsLogger
from ..train.grounding import finetune_constitutive, optimize_init_velocity
from ..train.schedulers import fetch_schedule
from ..utils.config import load_config
from ..utils.logging import Logger, Timer
from .common import (
    assemble_scene,
    background_color,
    build_materials,
    load_latest_lora,
    overlay_lora,
    resolve_exp_dirs,
    run_data_preparation,
    save_lora_checkpoint,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", "-c", type=str, required=True)
    parser.add_argument("--set", nargs="*", default=[], help="key.path=value overrides")
    return parser.parse_args(argv)


def _views(dataset, stage_cfg):
    views = stage_cfg.get("views", "all")
    return sorted(dataset.views if views == "all" else list(views))


def stage_scene(cfg, data_root, dataset, elasticity, plasticity, stage: str, device):
    """(scene, gt, init_data) of stage 1 (``stage="velocity"``) or stage 2
    (``stage="constitution"``) as the CLI trains it; stage 2's materials
    get LoRA factors drawn from ``cfg.seed``. ``dataset`` is read after
    ``background_color(cfg)``, which turns a mask-only dataset's
    background black."""
    stage_cfg = getattr(cfg, stage)
    lora = stage == "constitution"
    background, force_mask = background_color(cfg)
    scene, gt, init_data = assemble_scene(
        cfg, data_root, dataset, elasticity, plasticity,
        num_frames=int(stage_cfg.num_frames),
        substeps=int(stage_cfg.substeps) if lora else int(stage_cfg.get("substeps", 1)),
        used_views=_views(dataset, stage_cfg),
        pixel_loss=stage_cfg.get("pixel_loss", "l2"),
        background=background,
        force_mask=force_mask,
        exclude_frames=stage_cfg.get("exclude_steps", ()) if lora else (),
        device=device,
    )
    if lora:
        r, alpha = int(stage_cfg.lora.r), float(stage_cfg.lora.alpha)
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 42)))
        for material in (scene.elasticity, scene.plasticity):
            material.init_lora(gen, r=r, alpha=alpha)
            material.to(device)
    return scene, gt, init_data


def main(argv=None, device=None):
    args = parse_args(argv)
    device = resolve_device(device)
    cfg = load_config(args.config, args.set)

    # Multi-process entry (a no-op in one process): only the primary
    # writes checkpoints and logs.
    initialize(device)
    primary = is_primary()

    np.random.seed(cfg.get("seed", 42))
    resume = bool(cfg.get("resume", False))
    exp_root, tune_root = resolve_exp_dirs(cfg, resume, cfg.get("overwrite", False))
    logger = None
    if primary:
        cfg.save(exp_root / "config.yaml")
        logger = Logger.tee(exp_root / "log.txt")
    metrics = MetricsLogger(exp_root / "metrics.jsonl") if primary else None
    try:
        return _train(cfg, exp_root, tune_root, primary, metrics, resume, device)
    finally:
        if metrics:
            metrics.close()
        if logger is not None:
            logger.close()


def _train(cfg, exp_root, tune_root, primary, metrics, resume, device):
    timer = Timer()
    data_root = Path(cfg.get("data_root", exp_root / "sim_data"))
    data_root.mkdir(parents=True, exist_ok=True)
    background_color(cfg)  # before the dataset reads white_background

    run_data_preparation(cfg, data_root, device=device)

    dataset = VideoDataset(cfg.video_data.to_dict())
    elasticity, plasticity = build_materials(cfg)

    def scene_for(stage):
        return stage_scene(cfg, data_root, dataset, elasticity, plasticity, stage, device)

    # ---------------- stage 1: init velocity --------------------------
    vel_cfg = cfg.velocity
    init_path = tune_root / "init.npz"
    if init_path.is_file():
        print("Loading initial velocity from checkpoint ...")
        init_v = np.load(init_path)["init_v"]
    else:
        scene_v, gt_v, init_data = scene_for("velocity")
        print("Optimizing initial velocity ...")
        schedule = fetch_schedule(vel_cfg.scheduler.to_dict(), float(vel_cfg.lr))

        def vel_log(e, l, l_rgb, v):
            print(f"[velocity] epoch {e}/{vel_cfg.num_epochs} loss {l:.4e} init_v {v}")
            if metrics:
                metrics.log(e, stage=1.0, loss=l, loss_rgb=l_rgb, lr_velocity=schedule(e - 1))

        result = optimize_init_velocity(
            scene_v,
            gt_v,
            num_epochs=int(vel_cfg.num_epochs),
            lr=float(vel_cfg.lr),
            schedule=schedule,
            lambda_reg=vel_cfg.get("lambda_reg"),
            reg_all=bool(vel_cfg.get("reg_all", False)),
            log_fn=vel_log,
            device=device,
        )
        init_v = result.init_v
        if primary:
            np.savez(init_path, init_x=init_data.pos, init_v=init_v)
        del scene_v, gt_v
    print(f"Initial velocity obtained: {np.asarray(init_v).reshape(-1, 3).mean(0)}")

    # ---------------- stage 2: LoRA constitutive ----------------------
    con = cfg.constitution
    scene_c, gt_c, _ = scene_for("constitution")

    # Resume: the full train state (parameters, RAdam moments and step,
    # restored inside finetune_constitutive) when its file exists, else
    # the newest LoRA weights with a cold optimizer (finetune.py:299-309).
    start_epoch = 1
    ts_path = tune_root / "train_state.npz"
    full_resume = resume and ts_path.is_file()
    if full_resume:
        print(f"Resuming full train state from {ts_path}")
    elif resume:
        lora_tree, last_epoch = load_latest_lora(tune_root)
        if lora_tree is not None:
            print(f"Resuming LoRA from epoch {last_epoch} (weights only)")
            overlay_lora(scene_c.elasticity, lora_tree["elasticity"])
            overlay_lora(scene_c.plasticity, lora_tree["plasticity"])
            start_epoch = last_epoch + 1

    def con_log(e, l, en, pn, d, lr_e, lr_p):
        print(
            f"[constitutive] epoch {e}/{con.num_epochs} loss {l:.4e} "
            f"e-gd {en:.2e} p-gd {pn:.2e} decay {d:.2f} elp {timer.measure()}"
        )
        if metrics:
            metrics.log(
                e, stage=2.0, loss_rgb=l, grad_norm_elasticity=en,
                grad_norm_plasticity=pn, lr_decay=d, lr_elasticity=lr_e,
                lr_plasticity=lr_p,
            )

    keep = int(con.get("num_lora_ckpts", 3))
    result = finetune_constitutive(
        scene_c,
        gt_c,
        init_v,
        con.to_dict(),
        checkpoint_fn=(
            lambda e, a, b, l: save_lora_checkpoint(tune_root, e, a, b, l, keep)
        ) if primary else None,
        log_fn=con_log,
        start_epoch=start_epoch,
        train_state_path=ts_path,
        resume_state=full_resume,
        write_state=primary,
        device=device,
    )
    print("Finetuning ends.")
    return result


if __name__ == "__main__":
    main()
