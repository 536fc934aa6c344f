"""Shared app glue: experiment directories, data preparation, materials,
scene assembly from configs and the LoRA checkpoint ring.

Counterpart of ``neuma_tpu/apps/common.py`` (``TRAIN_EPS``,
``resolve_exp_dirs``, ``background_color``, ``run_data_preparation``,
``build_materials``, ``init_data_from_cfg``, ``assemble_scene``,
``save_lora_checkpoint``, ``load_latest_lora``, ``overlay_lora``), and
``load_lora`` with the serving apps' ``ServeResult``, ``OverflowWarning``,
``to_uint8`` and ``sync``. Two
differences follow from the port's trainers: the materials are modules
that carry their weights (so ``build_materials`` returns the two
modules and ``overlay_lora`` writes into one in place), and the ground
truth stays outside the scene (so ``assemble_scene`` returns
``(scene, gt, init_data)``). Without ``pretrained_ckpt`` the base
weights are drawn from a ``torch.Generator`` seeded with ``cfg.seed``:
other numbers than the JAX package's PRNG gives from that seed.
"""
from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import MPMConstants
from ..data.prepare import PREPARED_FILES, load_prepared, prepare_simulation_data
from ..data.readers import VideoDataset
from ..data.torch_ckpt import (
    load_base_model,
    load_params_npz,
    load_torch_file,
    merge_lora_state_dict,
    save_params_npz,
)
from ..materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from ..nn.mlp import LORA_LEAVES, MLP, lora_params
from ..render.rasterize import RasterConfig
from ..sim.initializers import MPMInitData, build_statics
from ..train.grounding import GroundingScene
from ..utils.config import Config

# The reference hard-forces eps = 6e-7 in every training entry point
# (finetune.py:47,105,270).
TRAIN_EPS = 6e-7


def resolve_exp_dirs(cfg: Config, resume: bool, overwrite: bool):
    exp_root = Path(cfg.root) / cfg.name
    if exp_root.exists() and not resume and overwrite:
        shutil.rmtree(exp_root)
    exp_root.mkdir(parents=True, exist_ok=True)
    tune_root = exp_root / "finetune"
    tune_root.mkdir(exist_ok=True)
    return exp_root, tune_root


def background_color(cfg: Config) -> Tuple[torch.Tensor, bool]:
    """White or black background; mask-only data forces black."""
    force_mask = bool(cfg.video_data.data.get("read_mask_only", False))
    white = bool(cfg.video_data.data.get("white_background", False))
    if force_mask:
        white = False
        cfg.video_data.data.white_background = False
    bg = torch.ones(3) if white else torch.zeros(3)
    return bg, force_mask


def run_data_preparation(cfg: Config, data_root: Path, device=None) -> None:
    """Prepare from ``particles_path`` or ``mesh_path``; with neither, the
    folder must already hold the prepared files (and the config needs no
    ``gaussian.kernels_path``). The binding runs on ``cuda`` unless
    ``device="cpu"``."""
    device = resolve_device(device)
    pd = cfg.particle_data

    def common():
        return dict(
            save_dir=data_root,
            kernels_path=Path(cfg.gaussian.kernels_path),
            sh_degree=cfg.gaussian.sh_degree,
            opacity_thres=cfg.gaussian.opacity_thres,
            confidence=cfg.gaussian.confidence,
            max_particles=cfg.gaussian.max_particles,
            device=device,
        )

    if pd.get("particles_path") is not None:
        prepare_simulation_data(
            particles_path=Path(pd.particles_path),
            particles_downsample_factor=pd.get("downsample_factor", 3),
            **common(),
        )
    elif pd.get("mesh_path") is not None:
        prepare_simulation_data(
            mesh_path=Path(pd.mesh_path),
            mesh_sample_mode=pd.mesh_sample_mode,
            mesh_sample_resolution=pd.mesh_sample_resolution,
            particles_downsample_factor=1,
            **common(),
        )
    else:
        missing = [f for f in PREPARED_FILES if not (data_root / f).is_file()]
        if missing:
            raise FileNotFoundError(
                f"No 'particles_path'/'mesh_path' in the config and the "
                f"assets dir {data_root} is missing {missing}; either "
                f"point the config at a particle source or pre-populate "
                f"the prepared assets."
            )


def build_materials(cfg: Config):
    """(elasticity, plasticity) modules with the base weights: a reference
    ``.pt`` pair, an ``.npz`` of either package, or drawn from
    ``cfg.seed``."""
    e_cfg = MetaMaterialConfig.from_cfg(cfg.constitution.elasticity)
    p_cfg = MetaMaterialConfig.from_cfg(cfg.constitution.plasticity)
    ckpt = cfg.get("pretrained_ckpt")
    if ckpt and str(ckpt).endswith(".pt"):
        pe, pp = load_base_model(ckpt, num_layers=len(e_cfg.layer_widths))
    elif ckpt and str(ckpt).endswith(".npz"):
        d = load_params_npz(ckpt)
        pe, pp = d["elasticity"], d["plasticity"]
    else:
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 42)))
        return (InvariantFullMetaElasticity.init(e_cfg, gen),
                InvariantFullMetaPlasticity.init(p_cfg, gen))
    return InvariantFullMetaElasticity(e_cfg, pe), InvariantFullMetaPlasticity(p_cfg, pp)


def init_data_from_cfg(cfg: Config, data_root: Path, nsteps: int) -> MPMInitData:
    """span = [0, nsteps]; the particle source is the prepared
    particles.ply in ``data_root``."""
    pd = cfg.particle_data.copy()
    pd.span = [0, nsteps]
    pd.shape.name = "particles"
    pd.shape.asset_root = str(data_root)
    return MPMInitData.from_cfg(pd.to_dict())


def assemble_scene(
    cfg: Config,
    data_root: Path,
    dataset: VideoDataset,
    elasticity,
    plasticity,
    num_frames: int,
    substeps: int,
    used_views: List[str],
    pixel_loss: str,
    background: torch.Tensor,
    force_mask: bool,
    exclude_frames=(),
    device=None,
) -> Tuple[GroundingScene, torch.Tensor, MPMInitData]:
    """The scene of one training stage, its ground truth
    (frames, views, 3, H, W) on ``device`` (``cuda`` unless
    ``device="cpu"``) and the particle group."""
    device = resolve_device(device)
    sim_cfg = cfg.sim.to_dict()
    sim_cfg["eps"] = TRAIN_EPS
    constants = MPMConstants.from_cfg(sim_cfg, device=device)

    init_data = init_data_from_cfg(cfg, data_root, num_frames * substeps)
    statics = build_statics([init_data], device=device)

    gaussians, particles, table = load_prepared(data_root, cfg.gaussian.sh_degree, device=device)
    if init_data.pos.shape[0] != particles.shape[0]:
        raise ValueError(
            f"Shape mismatch: init_data {init_data.pos.shape[0]} "
            f"prepared particles {particles.shape[0]}"
        )

    # Rollout frame f renders against dataset step steps[f + 1] (steps[0]
    # is the initial frame; finetune.py:154-156).
    frame_steps = [dataset.steps[f + 1] for f in range(num_frames)]
    gt = dataset.stacked_gt(used_views, frame_steps, device=device)
    cameras = [c.to(device) for c in dataset.cameras_for(used_views)]

    rcfg = cfg.get("raster", Config())
    raster_cfg = RasterConfig(
        max_pairs=int(rcfg.get("max_pairs", 1 << 18)),
        max_per_tile=int(rcfg.get("max_per_tile", 512)),
        segment=int(rcfg.get("segment", 32)),
    )
    scene = GroundingScene(
        constants=constants,
        statics=statics,
        elasticity=elasticity.to(device),
        plasticity=plasticity.to(device),
        gaussians=gaussians,
        binding=table,
        cameras=cameras,
        init_x=torch.as_tensor(init_data.pos, device=device),
        size=init_data.size,
        center=init_data.center,
        background=background.to(device),
        substeps=substeps,
        pixel_loss=pixel_loss,
        force_mask_data=force_mask,
        scaling_modifier=float(cfg.gaussian.get("scaling_modifier", 1.0)),
        raster_cfg=raster_cfg,
        exclude_frames=tuple(exclude_frames),
    )
    return scene, gt, init_data


def _lora_files(tune_root: Path) -> List[Path]:
    return sorted(tune_root.glob("*_lora.npz"), key=lambda p: int(p.stem.split("_")[0]))


def save_lora_checkpoint(
    tune_root: Path, epoch: int, params_e, params_p, loss: float, keep: int = 3
) -> None:
    """``{epoch:04d}_lora.npz`` with both materials' LoRA leaves and the
    loss; only the newest ``keep`` files stay (finetune.py:470-480)."""
    save_params_npz(
        tune_root / f"{epoch:04d}_lora.npz",
        {
            "elasticity": lora_params(params_e),
            "plasticity": lora_params(params_p),
            "loss": np.float32(loss),
        },
    )
    ckpts = _lora_files(tune_root)
    while len(ckpts) > keep:
        ckpts.pop(0).unlink()


def load_latest_lora(tune_root: Path):
    """(tree, epoch) of the newest LoRA file, or (None, 0)."""
    ckpts = _lora_files(tune_root)
    if not ckpts:
        return None, 0
    return load_params_npz(ckpts[-1]), int(ckpts[-1].stem.split("_")[0])


def overlay_lora(material, lora_tree) -> None:
    """Write a saved tree's ``lora_a`` / ``lora_b`` leaves into a material
    module that carries LoRA, in place."""
    tree = material.params()
    with torch.no_grad():
        for layer, saved in zip(tree["layers"] + [tree["final"]],
                                list(lora_tree["layers"]) + [lora_tree["final"]]):
            for k in LORA_LEAVES:
                if k in saved:
                    layer[k].copy_(torch.as_tensor(saved[k]))


def load_lora(elasticity, plasticity, path, r: int, alpha: float, seed: int) -> None:
    """Give both materials LoRA factors drawn from ``seed`` (the apps'
    ``init_lora``), then the saved ones, in place: the leaves of an
    ``.npz`` of either package (``overlay_lora``), or a reference
    ``{epoch}_lora.pt`` merged by ``merge_lora_state_dict``."""
    gen = torch.Generator().manual_seed(int(seed))
    for material in (elasticity, plasticity):
        device = next(material.parameters()).device
        material.init_lora(gen, r=r, alpha=alpha)
        material.to(device)
    if str(path).endswith(".npz"):
        lora = load_params_npz(path)
        overlay_lora(elasticity, lora["elasticity"])
        overlay_lora(plasticity, lora["plasticity"])
        return
    ckpt = load_torch_file(path)
    for key, material in (("elasticity", elasticity), ("plasticity", plasticity)):
        device = next(material.parameters()).device
        base = {"layers": [{k: v.detach().cpu() for k, v in layer.items()}
                           for layer in material.params()["layers"]],
                "final": {k: v.detach().cpu() for k, v in material.params()["final"].items()}}
        merged = merge_lora_state_dict(base, ckpt[key], len(base["layers"]), r, alpha)
        material.mlp = MLP(material.mlp_cfg, merged).to(device)


@dataclasses.dataclass
class ServeResult:
    """What a serving run wrote and how long its steps took (host clock,
    each step ended by a synchronize on the card): ``sim_ms`` per
    simulated step, ``render_ms[view]`` per rendered frame."""

    out_dir: Path
    frames: list
    particles: list
    videos: list
    sim_ms: list
    render_ms: dict
    overflow: bool


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU), so a host clock times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) in [0, 1] -> (H, W, 3) uint8, as the JAX apps write PNGs."""
    return np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)


class OverflowWarning:
    """Warns once when a render dropped pairs; reads the device flag on
    the host only until it has warned."""

    def __init__(self):
        self.warned = False

    def __call__(self, aux, where: str) -> None:
        if not self.warned and bool(aux["overflow"]):
            self.warned = True
            print(
                f"WARNING: raster pair budget exceeded at {where}; pairs were dropped and "
                "the image is wrong - raise raster.max_pairs/max_per_tile in the config."
            )
