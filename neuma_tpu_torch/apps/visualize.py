"""Interactive viewer CLI (reference ``experiments/visualization.py``):
pre-simulates the configured scene and serves the web viewer.

Counterpart of ``neuma_tpu/apps/visualize.py`` (``NEUMA_TO_LORA``,
``NEUMA_TO_BASE``, ``make_adaptor_registry``, ``parse_args``, ``main``).
Usage:

    python -m neuma_tpu_torch.apps.visualize -c configs/demo/multiobj-bb-cc.yaml \\
        [--port 8080] [--frames 100] [--substeps 1] [--up-axis y]

Each object is loaded by ``apps/inference.py::_load_object`` (prepared
assets, a reference ``.pt`` base pair and its optional LoRA). The
adaptor registry comes from the first object's config: the LoRA files
relative to the working directory, the base files beside that object's
``pretrained_ckpt``. An object's adaptor is the first name whose LoRA
directory (``v.split("/")[1]``) occurs in its ``load_lora`` string, as
in the JAX package. ``main(argv, device)`` runs on ``cuda`` unless
``device="cpu"`` is passed; without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..core.device import resolve_device
from ..core.types import MPMConstants
from ..render.rasterize import RasterConfig
from ..utils.config import Config, load_config
from ..vis.instance import NeuMAInstance, SceneObject
from ..vis.viewer import DynamicViewer
from .common import TRAIN_EPS, background_color, load_lora
from .inference import _load_object

# Reference viewer.py:16-32: the six pretrained NeuMAs selectable from
# the simulation panel, mapped to (base checkpoint, finetuned LoRA).
NEUMA_TO_LORA = {
    "bouncy": "logs/bouncyball-v1/finetune/1000_lora",
    "clay": "logs/claycat-v1/finetune/1000_lora",
    "honey": "logs/honeybottle-v1/finetune/1000_lora",
    "jelly": "logs/jellyduck-v1/finetune/1000_lora",
    "rubber": "logs/rubberpawn-v1/finetune/1000_lora",
    "sand": "logs/sandfish-v1/finetune/1000_lora",
}
NEUMA_TO_BASE = {
    "bouncy": "jelly_0300.pt",
    "clay": "plasticine_0300.pt",
    "honey": "sand_0300.pt",
    "jelly": "jelly_0300.pt",
    "rubber": "plasticine_0300.pt",
    "sand": "sand_0300.pt",
}


def make_adaptor_registry(obj_cfg: Config, base_dir: Path, seed: int):
    """Lazy loaders for each named NeuMA whose LoRA checkpoint exists on
    disk (``.npz`` from either package's finetune app, or the reference's
    ``.pt``) and whose base file lies beside ``pretrained_ckpt``. A loader
    returns ``{"params_e": tree, "params_p": tree}`` of CPU tensors: the
    base weights with LoRA drawn from ``seed``, then the file's leaves
    (``apps/common.py::load_lora``)."""
    from ..data.torch_ckpt import load_base_model
    from ..materials import (
        InvariantFullMetaElasticity,
        InvariantFullMetaPlasticity,
        MetaMaterialConfig,
    )

    e_cfg = MetaMaterialConfig.from_cfg(obj_cfg.constitution.elasticity)
    p_cfg = MetaMaterialConfig.from_cfg(obj_cfg.constitution.plasticity)
    n_layers = len(e_cfg.layer_widths)
    lora_cfg = obj_cfg.constitution.get("lora", {})
    r = int(lora_cfg.get("r", 1))
    alpha = float(lora_cfg.get("alpha", 1))
    base_models = Path(str(obj_cfg.get("pretrained_ckpt", ""))).parent

    registry = {}
    for name, rel in NEUMA_TO_LORA.items():
        lora_path = None
        for suffix in (".npz", ".pt"):
            cand = base_dir / (rel + suffix)
            if cand.is_file():
                lora_path = cand
                break
        if lora_path is None:
            continue
        base_path = base_models / NEUMA_TO_BASE[name]
        if not base_path.is_file():
            continue

        def load(lora_path=lora_path, base_path=base_path):
            pe, pp = load_base_model(base_path, num_layers=n_layers)
            elasticity = InvariantFullMetaElasticity(e_cfg, pe)
            plasticity = InvariantFullMetaPlasticity(p_cfg, pp)
            load_lora(elasticity, plasticity, lora_path, r, alpha, seed)
            tree = lambda m: {
                "layers": [{k: v.detach() for k, v in p.items()} for p in m.params()["layers"]],
                "final": {k: v.detach() for k, v in m.params()["final"].items()},
            }
            return {"params_e": tree(elasticity), "params_p": tree(plasticity)}

        registry[name] = load
    return registry


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--substeps", type=int, default=1)
    p.add_argument("--up-axis", choices=["x", "y", "z"], default="y")
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None, device=None) -> DynamicViewer:
    """Simulate, then serve until interrupted; returns the viewer when
    ``DynamicViewer.serve`` returns."""
    args = parse_args(argv)
    device = resolve_device(device)
    cfg = load_config(args.config, args.set)
    seed = int(cfg.get("seed", 42))

    background, _ = background_color(cfg)
    sim_cfg = cfg.sim.to_dict()
    sim_cfg.setdefault("eps", TRAIN_EPS)
    constants = MPMConstants.from_cfg(sim_cfg, device=device)

    up_axis = {"x": 0, "y": 1, "z": 2}[args.up_axis]
    objects = []
    registry = {}
    for obj_cfg in cfg.objects:
        bundle = _load_object(Config(obj_cfg.to_dict()), args.frames * args.substeps, seed, device)
        vel = obj_cfg.get_path("particle_data.vel.lin_vel")
        drop = abs(float(vel[up_axis])) if vel else 0.0
        lora_cfg = obj_cfg.constitution.get("lora", {})
        weight = float(lora_cfg.get("alpha", 1)) / max(int(lora_cfg.get("r", 1)), 1)
        load_lora_path = str(obj_cfg.constitution.get("load_lora") or "")
        adaptor = next(
            (k for k, v in NEUMA_TO_LORA.items() if v.split("/")[1] in load_lora_path),
            None,
        )
        objects.append(
            SceneObject(
                name=obj_cfg.sim_data_name,
                gaussians=bundle["gaussians"],
                binding=bundle["binding"],
                elasticity=bundle["elasticity"],
                plasticity=bundle["plasticity"],
                init_data=bundle["init_data"],
                scaling_modifier=bundle["scaling"],
                drop_vel=drop,
                lora_weight=weight,
                adaptor=adaptor,
                up_axis=up_axis,
            )
        )
        if not registry:
            # LoRA paths in NEUMA_TO_LORA are cwd-relative, matching the
            # configs' load_lora convention.
            registry = make_adaptor_registry(Config(obj_cfg.to_dict()), Path("."), seed)

    # raster.segment (the JAX package's jnp-backend remat knob) is not read.
    raster = cfg.get("raster", {})
    rcfg = RasterConfig(
        max_pairs=int(raster.get("max_pairs", 1 << 18)),
        max_per_tile=int(raster.get("max_per_tile", 512)),
    )
    instance = NeuMAInstance(
        constants,
        objects,
        num_frames=args.frames,
        substeps=args.substeps,
        background=background,
        raster_cfg=rcfg,
        adaptor_registry=registry,
        device=device,
    )
    print("Simulating rollout ...")
    instance.simulate()
    viewer = DynamicViewer(instance)
    viewer.serve(port=args.port)
    return viewer


if __name__ == "__main__":
    main()
