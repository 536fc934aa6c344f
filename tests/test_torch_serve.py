"""The port's serving CLIs (``neuma_tpu_torch.apps.render`` and
``.inference``) against the JAX package's on the CPU, each JAX app run
once (module-scoped fixtures).

* render: the fabricated scene of ``tests/test_apps.py``'s helpers
  (``num_grids`` 16, one 48 px view), a fabricated ``finetune/init.npz``,
  base weights given by ``-cbm`` and a LoRA ``.npz`` holding every LoRA
  leaf (no finetune run), ``--alpha``, ``-dt``, ``-sp``.
* inference: ``configs/demo/multiobj-bb-cc.yaml`` at the cuts of
  ``tests/test_config_families.py::test_demo_multiobj_inference``
  (``num_grids`` 16, 48 px, SH 2, fabricated assets in two sim regions),
  with reference-form ``.pt`` base files written by ``torch.save``,
  object 1's LoRA an ``.npz`` holding every leaf and object 2 without.

Both: the same file names, every PNG pixel within 1/255, every PLY
within a scaled 1e-5 (max error over the reference's largest value),
and a video or GIF per view. Every object's span is [0, eval_steps], so
the last step moves no particle in either package (the reference's
behaviour). Without a CUDA device both CLIs raise unless
``device="cpu"`` is passed.
"""
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from neuma_tpu.apps import common as jcommon
from neuma_tpu.apps import inference as jinference
from neuma_tpu.apps import render as jrender
from neuma_tpu.data.prepare import prepare_simulation_data
from neuma_tpu.data.torch_ckpt import save_params_npz
from neuma_tpu.utils.config import load_config as jax_load_config
from neuma_tpu_torch.apps import inference, render
from neuma_tpu_torch.data.ply import load_ply_points

from chip_smoke import reference_state_dict
from test_apps import make_assets, make_synthetic_dataset, write_config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
PLY_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lora_tree(material, params, key, r, alpha, rng):
    """Every LoRA leaf, with lora_b drawn nonzero so the LoRA term counts."""
    p = material.init_lora(params, key, r=r, alpha=alpha)
    for layer in p["layers"] + [p["final"]]:
        layer["lora_b"] = 0.1 * rng.standard_normal(np.shape(layer["lora_b"])).astype(np.float32)
    return _np(material.lora_params(p))


def _compare_images(port_dir, jax_dir, pattern):
    port = sorted(p.name for p in port_dir.glob(pattern))
    assert port and port == sorted(p.name for p in jax_dir.glob(pattern))
    worst = 0
    for name in port:
        a = np.asarray(Image.open(port_dir / name), np.int16)
        b = np.asarray(Image.open(jax_dir / name), np.int16)
        assert a.shape == b.shape
        worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1, f"PNG pixels differ by {worst}/255"
    return port


def _compare_plys(port_dir, jax_dir):
    names = sorted(p.name for p in port_dir.glob("*.ply"))
    assert names and names == sorted(p.name for p in jax_dir.glob("*.ply"))
    for name in names:
        a, b = load_ply_points(port_dir / name), load_ply_points(jax_dir / name)
        assert np.abs(a - b).max() <= PLY_TOL * np.abs(b).max(), name
    return names


# ----------------------------------------------------------------- render


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    rng = np.random.default_rng(0)
    views = make_synthetic_dataset(root / "dataset", rng)
    kernels, mesh = make_assets(root, rng)
    cfg_path = write_config(root, kernels, mesh, root / "dataset", views)
    jcfg = jax_load_config(cfg_path)
    data_root = root / "sim_data"
    jcommon.run_data_preparation(jcfg, data_root)
    init = jcommon.init_data_from_cfg(jcfg, data_root, 1)

    # base weights (-cbm), a LoRA file with every leaf, and init.npz
    e, p, pe, pp = jcommon.build_materials(jcfg)
    save_params_npz(root / "base.npz", {"elasticity": pe, "plasticity": pp})
    r, alpha = int(jcfg.constitution.lora.r), float(jcfg.constitution.lora.alpha)
    key = jax.random.PRNGKey(3)
    lora = {"elasticity": _lora_tree(e, pe, key, r, alpha, rng),
            "plasticity": _lora_tree(p, pp, jax.random.fold_in(key, 1), r, alpha, rng)}
    save_params_npz(root / "lora.npz", lora)
    init_v = np.array([1.5, -1.0, 0.8], np.float32)
    args = ["-c", str(cfg_path), "-s", "3", "-vn", "serve", "-dv", views[0], "-sp", "particles",
            "-l", str(root / "lora.npz"), "-cbm", str(root / "base.npz"), "--alpha", "0.002",
            "-dt", "0.005"]
    outs = {}
    for name, run in (("jax", lambda a: jrender.main(a)),
                      ("port", lambda a: render.main(a, device="cpu"))):
        logs = root / f"logs_{name}"
        (logs / "smoke" / "finetune").mkdir(parents=True)
        np.savez(logs / "smoke" / "finetune" / "init.npz", init_x=init.pos, init_v=init_v)
        outs[name] = run(args + ["--set", f"root={logs}"])
    return root, cfg_path, views, lora, outs["port"]


def test_render_matches_jax(rendered):
    root, _, views, _, result = rendered
    port, jax_ = (root / f"logs_{n}" / "smoke" / "results" for n in ("port", "jax"))
    frames = _compare_images(port / "serve", jax_ / "serve", "*.png")
    assert frames == [f"{views[0]}_{s:04d}.png" for s in (1, 2, 3)]
    plys = _compare_plys(port / "particles", jax_ / "particles")
    assert plys == [f"particles_{s:04d}.ply" for s in (1, 2, 3)]
    videos = sorted(p.name for p in port.glob(f"serve_{views[0]}.*"))
    assert videos and videos == sorted(p.name for p in jax_.glob(f"serve_{views[0]}.*"))
    assert [Path(v).name for v in result.videos] == videos
    assert len(result.sim_ms) == 3 and len(result.render_ms[views[0]]) == 3
    assert not result.overflow
    # the particles moved: the learned velocity and the LoRA were read
    first, last = (load_ply_points(port / "particles" / f"particles_{s:04d}.ply") for s in (1, 3))
    assert np.abs(last - first).max() > 0


def test_render_reads_a_reference_lora_checkpoint(rendered, tmp_path):
    """The same LoRA as a reference ``{epoch}_lora.pt`` (lora_A = a^T,
    lora_B = b^T): the merge gives the ``.npz`` overlay's frames bitwise."""
    root, cfg_path, views, lora, _ = rendered
    sd = {}
    for key in ("elasticity", "plasticity"):
        tree, d = lora[key], {}
        layers = [(f"layers.{i}.fc", l) for i, l in enumerate(tree["layers"])]
        for prefix, leaf in layers + [("final_layer.fc", tree["final"])]:
            d[f"{prefix}.lora_A"] = torch.from_numpy(np.ascontiguousarray(leaf["lora_a"].T))
            d[f"{prefix}.lora_B"] = torch.from_numpy(np.ascontiguousarray(leaf["lora_b"].T))
        sd[key] = d
    torch.save(sd, tmp_path / "0001_lora.pt")
    logs = tmp_path / "logs"
    (logs / "smoke" / "finetune").mkdir(parents=True)
    shutil.copy(root / "logs_port" / "smoke" / "finetune" / "init.npz", logs / "smoke" / "finetune")
    render.main(["-c", str(cfg_path), "-s", "3", "-vn", "pt", "-dv", views[0],
                 "-l", str(tmp_path / "0001_lora.pt"), "-cbm", str(root / "base.npz"),
                 "--alpha", "0.002", "-dt", "0.005", "--set", f"root={logs}"], device="cpu")
    ref = root / "logs_port" / "smoke" / "results" / "serve"
    got = logs / "smoke" / "results" / "pt"
    for s in (1, 2, 3):
        name = f"{views[0]}_{s:04d}.png"
        assert (got / name).read_bytes() == (ref / name).read_bytes()


# -------------------------------------------------------------- inference


def _multiobj_config(root, rng):
    cfg = yaml.safe_load((CONFIGS / "demo" / "multiobj-bb-cc.yaml").read_text())
    data_path = root / "dataset"
    make_synthetic_dataset(data_path, rng, size=48, views=["e_2"], n_steps=2,
                           subfolder="eval_dynamic")
    wrng = np.random.default_rng(42)
    for i, obj in enumerate(cfg["objects"]):
        obj_dir = root / f"obj{i}"
        obj_dir.mkdir()
        kernels, mesh = make_assets(obj_dir, rng)
        asset_root = root / "assets" / obj["sim_data_name"]
        prepare_simulation_data(save_dir=asset_root, kernels_path=kernels, mesh_path=mesh,
                                mesh_sample_mode="uniform", mesh_sample_resolution=8,
                                sh_degree=2, max_particles=8)
        obj["data_root"] = str(asset_root)
        obj["gaussian"]["sh_degree"] = 2
        obj["particle_data"]["shape"]["ori_bounds"] = [[0.2, 0.25, 0.2], [0.8, 0.85, 0.8]]
        obj["particle_data"]["shape"]["sim_bounds"] = (
            [[0.1, 0.3, 0.1], [0.45, 0.65, 0.45]] if i == 0
            else [[0.55, 0.3, 0.55], [0.9, 0.65, 0.9]])
        widths = obj["constitution"]["elasticity"]["layer_widths"]
        base = obj_dir / "base.pt"
        torch.save({"elasticity": reference_state_dict(wrng, widths),
                    "plasticity": reference_state_dict(wrng, widths)}, base)
        obj["pretrained_ckpt"] = str(base)
        obj["constitution"]["load_lora"] = None
    # object 1: a LoRA file holding every leaf (its r and alpha)
    from neuma_tpu.data.torch_ckpt import load_base_model
    from neuma_tpu.materials import InvariantFullMetaElasticity, MetaMaterialConfig

    con = cfg["objects"][0]["constitution"]
    mat = InvariantFullMetaElasticity(MetaMaterialConfig.from_cfg(con["elasticity"]))
    pe, pp = load_base_model(cfg["objects"][0]["pretrained_ckpt"], num_layers=2)
    r, alpha = con["lora"]["r"], con["lora"]["alpha"]
    key = jax.random.PRNGKey(9)
    save_params_npz(root / "obj0" / "lora.npz", {
        "elasticity": _lora_tree(mat, pe, key, r, alpha, rng),
        "plasticity": _lora_tree(mat, pp, jax.random.fold_in(key, 1), r, alpha, rng)})
    con["load_lora"] = str(root / "obj0" / "lora.npz")
    cfg["video_data"]["data"]["path"] = str(data_path)
    cfg["sim"]["num_grids"] = 16
    cfg["raster"] = {"max_pairs": 8192, "max_per_tile": 256}
    cfg_path = root / "multiobj.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return cfg_path


@pytest.fixture(scope="module")
def inferred(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    cfg_path = _multiobj_config(root, np.random.default_rng(1))
    args = ["-c", str(cfg_path), "-s", "3", "-vn", "mo", "-dv", "e_2", "-sp", "particles"]
    dt = "sim.dt=0.005"  # larger steps than the config's, so the frames move
    jinference.main(args + ["--set", f"root={root / 'jax'}", dt])
    result = inference.main(args + ["--set", f"root={root / 'port'}", dt], device="cpu")
    return root, cfg_path, result


def test_inference_matches_jax(inferred):
    root, _, result = inferred
    port, jax_ = root / "port" / "mo", root / "jax" / "mo"
    frames = _compare_images(port / "images", jax_ / "images", "*.png")
    assert frames == [f"e_2_{s:03d}.png" for s in range(4)]  # frame 0 undeformed
    plys = _compare_plys(port / "particles", jax_ / "particles")
    assert plys == [f"{s:03d}.ply" for s in (1, 2, 3)]  # first dataset step 0
    videos = sorted(p.name for p in port.glob("mo_e_2.*"))
    assert videos and videos == sorted(p.name for p in jax_.glob("mo_e_2.*"))
    assert len(result.sim_ms) == 3 and len(result.render_ms["e_2"]) == 4
    # the objects moved, and each object kept its own particles
    a, b = (load_ply_points(port / "particles" / f"{s:03d}.ply") for s in (1, 2))
    assert np.abs(b - a).max() > 0


def test_inference_last_step_moves_nothing(inferred):
    """At step == eval_steps every object is disabled ([0, eval_steps) is
    enabled), so the last step leaves the positions as they were, in the
    JAX package and in the port alike."""
    root, _, _ = inferred
    for side in ("jax", "port"):
        d = root / side / "mo" / "particles"
        before, last = load_ply_points(d / "002.ply"), load_ply_points(d / "003.ply")
        np.testing.assert_array_equal(last, before)


def test_serving_clis_need_a_card_or_the_cpu(rendered, inferred, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-device refusal")
    _, cfg_path, views, _, _ = rendered
    with pytest.raises(RuntimeError, match="CUDA"):
        render.main(["-c", str(cfg_path), "-s", "1", "-vn", "x", "--set",
                     f"root={tmp_path / 'r'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["-c", str(inferred[1]), "-s", "1", "-vn", "x", "--set",
                        f"root={tmp_path / 'i'}"])
    assert not (tmp_path / "r").exists() and not (tmp_path / "i").exists()


def test_rasterize_is_rasterize_with_aux_without_the_aux():
    from neuma_tpu_torch.render.camera import Camera
    from neuma_tpu_torch.render.gaussians import create_from_points
    from neuma_tpu_torch.render.rasterize import RasterConfig, rasterize, rasterize_with_aux

    rng = np.random.default_rng(0)
    pack = create_from_points(rng.uniform(0.3, 0.7, (200, 3)).astype(np.float32),
                              rng.random((200, 3)).astype(np.float32), sh_degree=1)
    cam = Camera.look_at(eye=np.array([0.5, 0.5, -1.0]), target=np.array([0.5, 0.5, 0.5]),
                         fov=0.8, width=32, height=32)
    args = (pack.xyz, pack.get_covariance(), pack.get_opacity, cam, torch.ones(3))
    kw = dict(shs=pack.get_features, sh_degree=1, cfg=RasterConfig(max_pairs=4096))
    with torch.no_grad():
        img = rasterize(*args, **kw)
        ref, _ = rasterize_with_aux(*args, **kw)
    assert img.shape == (3, 32, 32) and torch.equal(img, ref) and (img < 1).any()
