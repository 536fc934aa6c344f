"""The port's training CLI (``neuma_tpu_torch.apps.finetune``) and its app
glue (``apps/common.py``) on the CPU, on a dataset fabricated on disk
with ``tests/test_apps.py``'s helpers at that file's size.

* ``assemble_scene`` against the JAX package's on the same prepared
  folder: constants, statics, ``init_x``, Gaussians, binding, cameras and
  the ground truth bitwise (the same files read by the same numpy code),
  without jitting a rollout.
* The CLI end to end: the JAX app's artifact set, finite losses, metrics
  rows of both stages, and LoRA files the JAX package's
  ``load_params_npz`` reads.
* ``resume=true``: the full train state continues the run bitwise as if
  it had not stopped; without the file, the newest LoRA weights resume
  with a cold optimizer.
* Without a CUDA device the CLI raises unless ``device="cpu"``.
* ``parallel/distributed.py``: one process is primary with no process
  group; two (gloo, ``WORLD_SIZE=2``) form a group with rank 0 primary.
"""
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neuma_tpu.apps import common as jcommon
from neuma_tpu.data.readers import VideoDataset as JaxDataset
from neuma_tpu.data.torch_ckpt import load_params_npz as jax_load_params
from neuma_tpu.utils.config import load_config as jax_load_config
from neuma_tpu_torch import interop
from neuma_tpu_torch.apps import common, finetune
from neuma_tpu_torch.data.readers import VideoDataset
from neuma_tpu_torch.utils.config import load_config

from test_apps import make_assets, make_synthetic_dataset, write_config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


THREE = ["constitution.num_epochs=3"]


@pytest.fixture(scope="module")
def run3(tmp_path_factory):
    """The scene of ``tests/test_apps.py`` on disk and one CLI run of it on
    the CPU with 3 stage-2 epochs, shared by the tests below (which only
    read its files or copy them)."""
    root = tmp_path_factory.mktemp("app")
    rng = np.random.default_rng(0)
    views = make_synthetic_dataset(root / "dataset", rng)
    kernels, mesh = make_assets(root, rng)
    cfg_path = write_config(root, kernels, mesh, root / "dataset", views)
    result = finetune.main(["-c", str(cfg_path), "--set", *THREE], device="cpu")
    return root, cfg_path, result


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_assemble_scene_matches_jax(run3):
    root, cfg_path, _ = run3
    cfg = load_config(cfg_path, ["constitution.exclude_steps=[1]"])
    jcfg = jax_load_config(cfg_path, ["constitution.exclude_steps=[1]"])
    data_root = root / "sim_data"
    bg, force_mask = common.background_color(cfg)
    jbg, jforce = jcommon.background_color(jcfg)
    assert force_mask == jforce
    np.testing.assert_array_equal(bg.numpy(), np.asarray(jbg))

    con = cfg.constitution
    dataset, jdataset = VideoDataset(cfg.video_data.to_dict()), JaxDataset(jcfg.video_data.to_dict())
    e, p = common.build_materials(cfg)
    je, jp, jpe, jpp = jcommon.build_materials(jcfg)
    kw = dict(num_frames=int(con.num_frames), substeps=int(con.substeps), used_views=con.views,
              pixel_loss="l2", force_mask=force_mask, exclude_frames=con.exclude_steps)
    scene, gt, init = common.assemble_scene(cfg, data_root, dataset, e, p, background=bg,
                                          device="cpu", **kw)
    jscene, jinit = jcommon.assemble_scene(jcfg, data_root, jdataset, je, jp, jpe, jpp,
                                           background=jbg, **kw)
    np.testing.assert_array_equal(init.pos, jinit.pos)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jscene.gt_images))
    c, jc = scene.constants, jscene.constants
    assert (c.num_grids, c.bound, c.bc) == (jc.num_grids, jc.bound, jc.bc)
    for name in ("dt", "gravity", "eps"):
        np.testing.assert_array_equal(getattr(c, name).numpy(), np.asarray(getattr(jc, name)))
    for name in ("vol", "rho", "clip_bound", "enabled"):
        np.testing.assert_array_equal(getattr(scene.statics, name).numpy(),
                                      np.asarray(getattr(jscene.statics, name)))
    np.testing.assert_array_equal(scene.init_x.numpy(), np.asarray(jscene.init_x))
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(scene.gaussians, name).numpy(),
                                      np.asarray(getattr(jscene.gaussians, name)))
    np.testing.assert_array_equal(scene.binding.indices.numpy(), np.asarray(jscene.binding.indices))
    np.testing.assert_array_equal(scene.binding.weights.numpy(), np.asarray(jscene.binding.weights))
    assert len(scene.cameras) == len(jscene.cameras) == 1
    for name in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(scene.cameras[0], name).numpy(),
                                      np.asarray(getattr(jscene.cameras[0], name)))
    np.testing.assert_array_equal(scene.size, jscene.size)
    np.testing.assert_array_equal(scene.center, jscene.center)
    assert (scene.raster_cfg.max_pairs, scene.raster_cfg.max_per_tile) == (
        jscene.raster_cfg.max_pairs, jscene.raster_cfg.max_per_tile)
    assert tuple(scene.exclude_frames) == tuple(jscene.exclude_frames) == (1,)
    assert (scene.substeps, scene.scaling_modifier, scene.force_mask_data) == (
        jscene.substeps, jscene.scaling_modifier, jscene.force_mask_data)


def _rows(exp_root):
    return [json.loads(line) for line in (exp_root / "metrics.jsonl").open()]


def test_finetune_cli_end_to_end(run3):
    root, cfg_path, result = run3
    assert len(result.losses) == 3 and np.all(np.isfinite(result.losses))
    exp_root = root / "logs" / "smoke"
    tune = exp_root / "finetune"
    for name in ("config.yaml", "log.txt", "metrics.jsonl"):
        assert (exp_root / name).is_file(), name
    for name in ("init.npz", "0001_lora.npz", "0003_lora.npz", "train_state.npz"):
        assert (tune / name).is_file(), name
    for name in ("kernels.ply", "particles.ply", "bindings.npz", "n_particles.npy", "particles.npz"):
        assert (root / "sim_data" / name).is_file(), name
    assert load_config(exp_root / "config.yaml").to_dict() == load_config(cfg_path, THREE).to_dict()
    log = (exp_root / "log.txt").read_text()
    assert "Optimizing initial velocity" in log and "Finetuning ends." in log
    rows = _rows(exp_root)
    assert [(r["stage"], r["step"]) for r in rows] == [(1.0, 1), (1.0, 2), (2.0, 1), (2.0, 2),
                                                       (2.0, 3)]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    np.testing.assert_array_equal([r["loss_rgb"] for r in rows[2:]], np.float64(result.losses))

    lora = jax_load_params(tune / "0003_lora.npz")
    np.testing.assert_allclose(float(lora["loss"]), result.losses[-1], rtol=1e-7)
    for key, params in (("elasticity", result.params_e), ("plasticity", result.params_p)):
        want = interop.lora_leaves(interop.to_numpy(params))
        got = interop.lora_leaves(_np(lora[key]))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    init = np.load(tune / "init.npz")
    assert init["init_v"].shape == (3,) and np.isfinite(init["init_v"]).all()


def test_finetune_cli_resume(run3, tmp_path):
    """A two-epoch run (stage 1 reloaded from the shared run's
    ``init.npz``), then ``resume=true`` to three epochs: the full train
    state gives the shared three-epoch run's third epoch bitwise (loss and
    LoRA leaves). Without the train-state file the newest LoRA file
    resumes (weights only) at the next epoch."""
    root, cfg_path, straight = run3
    exp_root = tmp_path / "logs" / "smoke"
    (exp_root / "finetune").mkdir(parents=True)
    shutil.copy(root / "logs" / "smoke" / "finetune" / "init.npz", exp_root / "finetune")
    here = [f"root={tmp_path / 'logs'}"]
    finetune.main(["-c", str(cfg_path), "--set", *here], device="cpu")
    resumed = finetune.main(["-c", str(cfg_path), "--set", *here, "resume=true", *THREE],
                            device="cpu")
    log = (exp_root / "log.txt").read_text()
    assert "Loading initial velocity from checkpoint" in log
    assert "Resuming full train state" in log and "Data already prepared" in log
    assert "Resuming" not in (root / "logs" / "smoke" / "log.txt").read_text(), (
        "each run's tee ends with the run")
    assert resumed.losses == straight.losses[2:]
    for a, b in ((resumed.params_e, straight.params_e), (resumed.params_p, straight.params_p)):
        for x, y in zip(interop.lora_leaves(a), interop.lora_leaves(b)):
            assert torch.equal(x, y)
    assert [r["step"] for r in _rows(exp_root) if r["stage"] == 2.0] == [1, 2, 3]
    assert sorted(p.name for p in (exp_root / "finetune").glob("*_lora.npz")) == [
        "0001_lora.npz", "0002_lora.npz", "0003_lora.npz"]

    (exp_root / "finetune" / "train_state.npz").unlink()
    weights_only = finetune.main(["-c", str(cfg_path), "--set", *here, "resume=true",
                                  "constitution.num_epochs=4", "constitution.num_lora_ckpts=2"],
                                 device="cpu")
    assert len(weights_only.losses) == 1 and np.isfinite(weights_only.losses[0])
    assert "Resuming LoRA from epoch 3 (weights only)" in (exp_root / "log.txt").read_text()
    assert sorted(p.name for p in (exp_root / "finetune").glob("*_lora.npz")) == [
        "0003_lora.npz", "0004_lora.npz"]


def test_finetune_cli_needs_a_card_or_the_cpu(run3, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-device refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main(["-c", str(run3[1]), "--set", f"root={tmp_path / 'logs'}"])
    assert not (tmp_path / "logs").exists(), "nothing was written before the refusal"


def test_prepared_assets_without_a_source(run3, tmp_path):
    """No particle source: the folder must already hold the prepared files."""
    root, cfg_path, _ = run3
    cfg = load_config(cfg_path, ["particle_data.mesh_path=null"])
    with pytest.raises(FileNotFoundError, match="missing"):
        common.run_data_preparation(cfg, tmp_path / "empty", device="cpu")
    common.run_data_preparation(cfg, root / "sim_data", device="cpu")


_RANK = """
import json, torch.distributed as dist
from neuma_tpu_torch.parallel import distributed
started = distributed.initialize()
print(json.dumps([started, distributed.is_primary(), dist.get_world_size()]))
dist.destroy_process_group()
"""


def test_distributed_entry(tmp_path):
    """One process: no process group, and primary. Two processes with
    ``WORLD_SIZE=2`` (gloo on the CPU): a group of two, rank 0 primary."""
    from neuma_tpu_torch.parallel import distributed

    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    assert not distributed.initialize() and distributed.is_primary()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK], stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**env, "WORLD_SIZE": "2", "RANK": str(rank), "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port)}) for rank in range(2)]
    outs = [json.loads(p.communicate(timeout=120)[0].strip().splitlines()[-1]) for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [[True, True, 2], [True, False, 2]]
