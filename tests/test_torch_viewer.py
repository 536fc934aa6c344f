"""The port's viewer (``neuma_tpu_torch.vis`` and ``apps/visualize.py``)
against the JAX package's on the CPU.

* ``vis/campath.py::spline_path`` bitwise (holds, ``loop``, default fovs,
  coincident keyframes).
* ``NeuMAInstance.simulate`` on ``tests/test_viewer.py``'s scene, on the
  dense grid (16 cells) and on the slab grid (32 cells: the plain
  versions of K1 and K2), both from one JAX instance simulated twice (one
  module-scoped fixture): every frame's means and covariances within a
  scaled 1e-5 (max error over the reference's largest value), every
  ``render_frame`` pixel within 1/255. The raster budget keeps every tile
  under ``max_per_tile``, so the JAX jnp backend drops nothing.
* ``apply_object_settings`` for each key against the JAX class's,
  including two objects that pick one adaptor with two weights (the
  port copies the registry entry into each object's own materials).
* The HTTP endpoints on ``device="cpu"``: the page and ``/info`` bodies
  equal to the JAX viewer's, ``/render`` byte-equal to a direct render's
  JPEG, both ``/render_path`` payloads, ``/resimulate``, and 404s.
* ``make_adaptor_registry`` over fabricated ``.npz`` and ``.pt`` LoRA
  files against the JAX package's, and ``visualize.main`` with
  ``DynamicViewer.serve`` made non-blocking.
"""
import io
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from neuma_tpu.apps import visualize as jvisualize
from neuma_tpu.core.types import MPMConstants
from neuma_tpu.data.torch_ckpt import save_params_npz
from neuma_tpu.materials import (
    CorotatedElasticity,
    IdentityPlasticity,
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu.render.binding import compute_binding_table
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu.render.gaussians import create_from_points
from neuma_tpu.render.rasterize import RasterConfig as JaxRasterConfig
from neuma_tpu.sim.initializers import MPMInitData
from neuma_tpu.utils.config import Config as JaxConfig
from neuma_tpu.vis import campath as jcampath
from neuma_tpu.vis import instance as jinstance
from neuma_tpu.vis import viewer as jviewer
from neuma_tpu_torch import interop
from neuma_tpu_torch.apps import visualize
from neuma_tpu_torch.render.camera import Camera
from neuma_tpu_torch.render.rasterize import RasterConfig
from neuma_tpu_torch.utils.config import Config
from neuma_tpu_torch.vis import campath, instance, viewer

from chip_smoke import reference_state_dict
from test_apps import make_assets
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TOL = 1e-5
FRAMES = 2
RASTER = dict(max_pairs=4096, max_per_tile=256)
CAMERAS = (((0.5, 0.6, -1.0), (0.5, 0.5, 0.5)), ((1.3, 0.9, 0.2), (0.5, 0.5, 0.5)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _constants(g):
    return MPMConstants(num_grids=g, bound=2, bc="freeslip", dt=jnp.float32(5e-4),
                        gravity=jnp.asarray([0, -9.8, 0], jnp.float32), eps=jnp.float32(6e-7))


def _blob(rng, n, offset=0.0):
    pts = (0.45 + offset + 0.1 * rng.random((n, 3))).astype(np.float32)
    pack = create_from_points(pts, rng.random((n, 3)).astype(np.float32), sh_degree=0)
    table = compute_binding_table(pack, jnp.asarray(pts), max_particles=6)
    init = MPMInitData.from_points(pts, total_volume=0.001, rho=1000.0, clip_bound=0.1,
                                   span=(0, 10 ** 9))
    return pack, table, init


def _jax_instance():
    """``tests/test_viewer.py::make_instance`` with the parity raster budget."""
    rng = np.random.default_rng(0)
    pack, table, init = _blob(rng, 100)
    e, p = CorotatedElasticity({"E": 1e4, "nu": 0.3}), IdentityPlasticity()
    obj = jinstance.SceneObject(name="blob", gaussians=pack, binding=table, elasticity=e,
                                plasticity=p, params_e=e.init(), params_p=p.init(),
                                init_data=init)
    return jinstance.NeuMAInstance(_constants(16), [obj], num_frames=FRAMES,
                                   raster_cfg=JaxRasterConfig(**RASTER, segment=8))


def _port_instance(jinst, g):
    return instance.NeuMAInstance(
        interop.constants_from_numpy(_np(_constants(g))),
        [interop.scene_object_from_numpy(o) for o in jinst.objects],
        num_frames=jinst.num_frames, raster_cfg=RasterConfig(**RASTER), device="cpu")


@pytest.fixture(scope="module")
def simulated():
    """The JAX instance simulated on the dense and the slab grid, with its
    renders from ``CAMERAS``."""
    jinst = _jax_instance()
    out = {}
    for g in (16, 32):
        jinst.constants = _constants(g)
        jinst.simulate()
        renders = [jinst.render_frame(f, JaxCamera.look_at(eye=np.array(e), target=np.array(t),
                                                           width=64, height=64))
                   for f, (e, t) in zip(range(FRAMES), CAMERAS)]
        out[g] = ([dict(f) for f in jinst.frames], renders)
    return jinst, out


# -------------------------------------------------------------- campath


KEYS = [
    {"eye": [0.0, 0.0, 0.0], "target": [1.0, 0.0, 0.0], "hold_sec": 0.1},
    {"eye": [1.0, 1.0, 0.0], "target": [1.0, 1.0, 1.0], "transition_sec": 0.5},
    {"eye": [2.0, 0.0, 1.0], "target": [0.0, 1.0, 1.0], "transition_sec": 1.0, "fov": 1.1},
]


@pytest.mark.parametrize("case", ["holds", "loop", "default_fov", "coincident"])
def test_spline_path_is_the_jax_packages(case):
    keys, kw = KEYS, dict(fps=10, default_fov=0.8)
    if case == "loop":
        keys, kw = [dict(k, hold_sec=0) for k in KEYS], dict(fps=12, loop=True,
                                                              default_transition_sec=0.5)
    elif case == "default_fov":
        kw = dict(fps=7)
    elif case == "coincident":
        keys = [KEYS[0], dict(KEYS[0], hold_sec=0.3), KEYS[1], KEYS[1]]
    got, want = campath.spline_path(keys, **kw), jcampath.spline_path(keys, **kw)
    assert len(got) == len(want) > 0
    for (e, t, f), (we, wt, wf) in zip(got, want):
        assert np.array_equal(e, we) and np.array_equal(t, wt) and f == wf
    assert np.all(np.isfinite(np.array([g[0] for g in got])))


# ------------------------------------------------------------- instance


@pytest.mark.parametrize("g", [16, 32])
def test_simulate_and_render_match_jax(simulated, g):
    jinst, out = simulated
    frames, renders = out[g]
    inst = _port_instance(jinst, g)
    inst.simulate()
    assert len(inst.frames) == FRAMES
    for f, (got, want) in enumerate(zip(inst.frames, frames)):
        for key in ("means", "cov"):
            assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
            assert _scaled(got[key], want[key]) <= TOL, (f, key, _scaled(got[key], want[key]))
    moved = np.abs(inst.frames[-1]["means"] - np.asarray(jinst.objects[0].gaussians.xyz)).max()
    assert moved > 0
    for f, ((e, t), want) in enumerate(zip(CAMERAS, renders)):
        img = inst.render_frame(f, Camera.look_at(eye=np.array(e), target=np.array(t),
                                                  width=64, height=64))
        assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
        assert np.abs(img.astype(np.int16) - want.astype(np.int16)).max() <= 1
        assert (img != 255).mean() > 0.01  # the blob is in view
    # a second rollout repeats bit for bit
    first = [dict(f) for f in inst.frames]
    inst.simulate()
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(first, inst.frames) for k in a)


def test_simulate_and_render_build_no_graph_on_any_thread(monkeypatch):
    """Grad mode is per thread and starts enabled in each: ``simulate`` and
    ``render_frame`` enter ``no_grad`` themselves, so the step and the
    rasterizer run without autograd on a server thread."""
    import threading

    seen = []
    for name in ("mpm_step", "rasterize"):
        fn = getattr(instance, name)
        monkeypatch.setattr(instance, name, lambda *a, _fn=fn, _n=name, **k: (
            seen.append((_n, torch.is_grad_enabled())), _fn(*a, **k))[1])
    inst = _port_instance(_jax_instance(), 16)
    cam = Camera.look_at(eye=np.array(CAMERAS[0][0]), target=np.array(CAMERAS[0][1]),
                         width=32, height=32)
    thread_grad = []

    def run():
        thread_grad.append(torch.is_grad_enabled())
        inst.simulate()
        inst.render_frame(0, cam)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert thread_grad == [True]
    assert sorted(set(seen)) == [("mpm_step", False), ("rasterize", False)]


# ------------------------------------------------------ panel settings


def _meta_objects(rng, names):
    """Objects with LoRA-bearing InvariantFull materials (widths 16, r 4) and
    a registry of two adaptors, as ``tests/test_viewer.py::make_meta_instance``."""
    cfg = MetaMaterialConfig(layer_widths=(16, 16))
    e, p = InvariantFullMetaElasticity(cfg), InvariantFullMetaPlasticity(cfg)
    key = jax.random.PRNGKey(0)
    pe = jax.tree_util.tree_map(lambda x: 0.05 * x, e.init(key))
    pp = jax.tree_util.tree_map(lambda x: 0.05 * x, p.init(jax.random.fold_in(key, 1)))
    pe = e.init_lora(pe, key, r=4, alpha=4)
    pp = p.init_lora(pp, jax.random.fold_in(key, 2), r=4, alpha=4)
    registry = {"jelly": {"params_e": pe, "params_p": pp},
                "sand": {"params_e": jax.tree_util.tree_map(lambda x: 0.5 * x, pe),
                         "params_p": jax.tree_util.tree_map(lambda x: 0.5 * x, pp)}}
    objs = []
    for i, name in enumerate(names):
        pack, table, init = _blob(rng, 40, offset=0.2 * i)
        objs.append(jinstance.SceneObject(name=name, gaussians=pack, binding=table,
                                          elasticity=e, plasticity=p, params_e=pe, params_p=pp,
                                          init_data=init, adaptor="jelly"))
    return objs, registry


def _port_registry(registry):
    """The JAX registry as the port's trees of tensors, the ``sand`` entry
    behind a lazy loader."""
    to_t = lambda tree: jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    out = {"jelly": {k: to_t(v) for k, v in registry["jelly"].items()}}
    out["sand"] = lambda: {k: to_t(v) for k, v in registry["sand"].items()}
    return out


def _assert_params_equal(module, tree):
    got = interop.to_numpy(module.params())
    want = _np(tree)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


EDITS = [
    ("a", {"drop_vel": 0.4}),
    ("a", {"weight": 0.25}),
    ("b", {"exists": False}),
    ("a", {"adaptor": "sand"}),
    ("b", {"adaptor": "sand", "weight": 0.75, "exists": True}),
    ("a", {"adaptor": "jelly", "drop_vel": 0.1}),
    ("a", {"adaptor": None}),
]


def test_apply_object_settings_matches_jax():
    """Each key, in order, on both packages; the two objects share the
    ``sand`` adaptor with weights 0.25 and 0.75 at one point: the port's
    objects keep their own ``lora_scale`` and the registry's tree stays
    as it was loaded."""
    objs, registry = _meta_objects(np.random.default_rng(3), ["a", "b"])
    jinst = jinstance.NeuMAInstance(_constants(16), objs, num_frames=1,
                                    adaptor_registry=registry)
    tinst = instance.NeuMAInstance(interop.constants_from_numpy(_np(_constants(16))),
                                   [interop.scene_object_from_numpy(o) for o in objs],
                                   num_frames=1, adaptor_registry=_port_registry(registry),
                                   device="cpu")
    for step, (name, settings) in enumerate(EDITS):
        jinst.apply_object_settings(name, settings)
        tinst.apply_object_settings(name, settings)
        for jo, to in zip(jinst.objects, tinst.objects):
            assert (to.enabled, to.drop_vel, to.lora_weight, to.adaptor) == (
                jo.enabled, jo.drop_vel, jo.lora_weight, jo.adaptor), step
            np.testing.assert_array_equal(to.init_data.lin_vel, jo.init_data.lin_vel)
            _assert_params_equal(to.elasticity, jo.params_e)
            _assert_params_equal(to.plasticity, jo.params_p)
        if step == 4:  # both on "sand": 0.25 and 0.75
            scales = [float(o.elasticity.mlp.final.lora_scale) for o in tinst.objects]
            assert scales == [0.25, 0.75]
            assert tinst.objects[0].elasticity.mlp is not tinst.objects[1].elasticity.mlp
            sand = tinst.adaptor_registry["sand"]["params_e"]
            assert float(sand["final"]["lora_scale"]) == 0.5  # as loaded: 0.5 x alpha / r
    np.testing.assert_array_equal(tinst.objects[0].init_data.lin_vel, [0, -0.1, 0])


# ----------------------------------------------------------------- HTTP


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _status(fn):
    try:
        return fn()[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_viewer_endpoints_match_jax(simulated, monkeypatch):
    """A fresh JAX instance holding the fixture's slab-grid frames (its
    ``simulate`` is not run again: ``/resimulate`` compares the handler and
    the panel state) against the port's instance on the same scene."""
    jinst = _jax_instance()
    jinst.constants = _constants(32)
    jinst.frames = simulated[1][32][0]
    monkeypatch.setattr(jinst, "simulate", lambda: None)
    inst = _port_instance(jinst, 32)
    inst.simulate()
    servers = []
    try:
        bases = []
        for v in (viewer.DynamicViewer(inst, width=48, height=48),
                  jviewer.DynamicViewer(jinst, width=48, height=48)):
            servers.append(v.serve(port=0, blocking=False))
            bases.append(f"http://127.0.0.1:{servers[-1].server_address[1]}")
        port, jax_ = bases
        for path in ("/", "/info"):
            assert _get(port + path) == _get(jax_ + path), path
        assert viewer._PAGE == jviewer._PAGE
        q = "/render?frame=1&ex=1.3&ey=0.9&ez=0.2&tx=0.5&ty=0.5&tz=0.5"
        status, ctype, body = _get(port + q)
        assert (status, ctype) == (200, "image/jpeg") == _get(jax_ + q)[:2]
        direct = inst.render_frame(1, Camera.look_at(eye=np.array([1.3, 0.9, 0.2]),
                                                     target=np.array([0.5, 0.5, 0.5]),
                                                     fov=0.9, width=48, height=48))
        buf = io.BytesIO()
        Image.fromarray(direct).save(buf, format="JPEG", quality=90)
        assert body == buf.getvalue()
        assert np.asarray(Image.open(io.BytesIO(body))).shape == (48, 48, 3)
        for base in bases:
            assert _status(lambda: _get(base + "/nothing")) == 404
            assert _status(lambda: _post(base + "/nothing", {})) == 404

        # the spline payload and the legacy steps_per_segment one
        keys = [{"eye": [0.5, 0.6, -1.0], "target": [0.5, 0.5, 0.5], "hold_sec": 0.2},
                {"eye": [-1.0, 0.6, 0.5], "target": [0.5, 0.5, 0.5], "transition_sec": 0.3}]
        _, ctype, body = _post(port + "/render_path", {"keyframes": keys, "fps": 10,
                                                        "loop": True})
        video = Path(json.loads(body)["path"])
        assert ctype == "application/json" and video.is_file()
        poses = campath.spline_path(keys, fps=10, default_transition_sec=0.4, loop=True,
                                    default_fov=0.9)
        assert len(list(video.parent.glob("path_*.png"))) == len(poses) == 9
        _, _, body = _post(port + "/render_path", {"keyframes": keys, "spline": False,
                                                    "steps_per_segment": 3})
        video = Path(json.loads(body)["path"])
        assert video.is_file() and len(list(video.parent.glob("path_*.png"))) == 3

        # /resimulate: the same body, then the same /info
        edits = {"objects": {"blob": {"exists": True, "drop_vel": 0.3, "weight": 0.5}}}
        assert _post(port + "/resimulate", edits) == _post(jax_ + "/resimulate", edits)
        assert _get(port + "/info") == _get(jax_ + "/info")
        assert _post(port + "/resimulate", {"objects": {"blob": False}})[2] == b"{}"
        assert inst.frames == [] and json.loads(_get(port + "/info")[2])["num_frames"] == 0
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


# ------------------------------------------------- registry and the CLI


def _fabricate_adaptors(root: Path, widths=(16, 16), r=4, alpha=4.0):
    """``base_models/{jelly,plasticine}_0300.pt`` of reference-form weights,
    the bouncy LoRA as an ``.npz`` (every leaf) and the clay LoRA as a
    reference ``.pt``, all under ``root``."""
    rng = np.random.default_rng(5)
    base = root / "base_models"
    base.mkdir(parents=True)
    for name in ("jelly_0300.pt", "plasticine_0300.pt"):
        torch.save({"elasticity": reference_state_dict(rng, widths),
                    "plasticity": reference_state_dict(rng, widths)}, base / name)

    def lora_tree():
        dims = [13] + list(widths) + [9]
        layer = lambda i, o: {"lora_a": rng.standard_normal((i, r)).astype(np.float32) * 0.1,
                              "lora_b": rng.standard_normal((r, o)).astype(np.float32) * 0.1}
        layers = [layer(dims[i], dims[i + 1]) for i in range(len(widths))]
        return {"layers": layers, "final": layer(dims[-2], dims[-1])}

    bouncy = root / "logs" / "bouncyball-v1" / "finetune"
    bouncy.mkdir(parents=True)
    save_params_npz(bouncy / "1000_lora.npz",
                    {"elasticity": lora_tree(), "plasticity": lora_tree()})
    clay = root / "logs" / "claycat-v1" / "finetune"
    clay.mkdir(parents=True)
    sd = {}
    for key in ("elasticity", "plasticity"):
        t = lora_tree()
        named = [(f"layers.{i}.fc", l) for i, l in enumerate(t["layers"])]
        sd[key] = {f"{p}.lora_{c}": torch.from_numpy(np.ascontiguousarray(l[f"lora_{c.lower()}"].T))
                   for p, l in named + [("final_layer.fc", t["final"])] for c in "AB"}
    torch.save(sd, clay / "1000_lora.pt")
    return base


def _obj_cfg(base: Path, widths=(16, 16)):
    con = {"elasticity": {"layer_widths": list(widths)},
           "plasticity": {"layer_widths": list(widths), "alpha": 0.001},
           "lora": {"r": 4, "alpha": 4}}
    return {"pretrained_ckpt": str(base / "jelly_0300.pt"), "constitution": con}


def test_make_adaptor_registry_matches_jax(tmp_path):
    base = _fabricate_adaptors(tmp_path)
    d = _obj_cfg(base)
    got = visualize.make_adaptor_registry(Config(d), tmp_path, seed=42)
    want = jvisualize.make_adaptor_registry(JaxConfig(d), tmp_path, seed=42)
    assert sorted(got) == sorted(want) == ["bouncy", "clay"]
    for name in got:
        g, w = got[name](), want[name]()
        for key in ("params_e", "params_p"):
            gl = jax.tree_util.tree_leaves(interop.to_numpy(g[key]))
            wl = jax.tree_util.tree_leaves(_np(w[key]))
            assert len(gl) == len(wl) == 12  # 3 linears x (kernel, lora_a, lora_b, lora_scale)
            for a, b in zip(gl, wl):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_visualize_main_serves(tmp_path, monkeypatch):
    """The CLI on multiobj-bb-cc.yaml at small cuts (16 cells, widths 16,
    LoRA r 4, SH 2, fabricated prepared assets), run from a working directory
    that holds both LoRA files: two objects, their adaptors found by the
    substring rule, both registry entries, and the frames simulated."""
    from neuma_tpu_torch.data.prepare import prepare_simulation_data

    base = _fabricate_adaptors(tmp_path)
    cfg = yaml.safe_load((CONFIGS / "demo" / "multiobj-bb-cc.yaml").read_text())
    rng = np.random.default_rng(1)
    for i, obj in enumerate(cfg["objects"]):
        obj_dir = tmp_path / f"obj{i}"
        obj_dir.mkdir()
        kernels, mesh = make_assets(obj_dir, rng)
        prepare_simulation_data(save_dir=obj_dir / "assets", kernels_path=kernels,
                                mesh_path=mesh, mesh_sample_mode="uniform",
                                mesh_sample_resolution=8, sh_degree=2, max_particles=8,
                                device="cpu")
        obj["data_root"] = str(obj_dir / "assets")
        obj["gaussian"]["sh_degree"] = 2
        obj["pretrained_ckpt"] = str(base / ("jelly_0300.pt" if i == 0 else "plasticine_0300.pt"))
        obj["particle_data"]["shape"]["ori_bounds"] = [[0.2, 0.25, 0.2], [0.8, 0.85, 0.8]]
        obj["particle_data"]["shape"]["sim_bounds"] = (
            [[0.1, 0.3, 0.1], [0.45, 0.65, 0.45]] if i == 0 else [[0.55, 0.3, 0.55],
                                                                    [0.9, 0.65, 0.9]])
        for m in ("elasticity", "plasticity"):
            obj["constitution"][m]["layer_widths"] = [16, 16]
        obj["constitution"]["lora"]["r"] = 4
    cfg["objects"][1]["constitution"]["load_lora"] = "logs/claycat-v1/finetune/1000_lora.pt"
    cfg["sim"]["num_grids"] = 16
    cfg["raster"]["segment"] = 16
    cfg_path = tmp_path / "multiobj.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    servers, original = [], viewer.DynamicViewer.serve

    def serve(self, port=8080, blocking=True):
        servers.append(original(self, port=0, blocking=False))
        return servers[-1]

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(viewer.DynamicViewer, "serve", serve)
    v = visualize.main(["-c", str(cfg_path), "--frames", "2", "--port", "0"], device="cpu")
    try:
        inst = v.instance
        assert [o.name for o in inst.objects] == ["bouncyball", "claycat"]
        assert [o.adaptor for o in inst.objects] == ["bouncy", "clay"]
        assert [o.lora_weight for o in inst.objects] == [1.0, 4.0]
        assert [o.drop_vel for o in inst.objects] == [0.5, 0.5]
        assert sorted(inst.adaptor_registry) == ["bouncy", "clay"]
        rc = inst.raster_cfg  # the config's raster.segment (16) is not read
        assert (rc.max_pairs, rc.max_per_tile) == (cfg["raster"]["max_pairs"],
                                                   cfg["raster"]["max_per_tile"])
        assert len(inst.frames) == 2
        info = json.loads(_get(f"http://127.0.0.1:{servers[0].server_address[1]}/info")[2])
        assert info["adaptors"] == ["bouncy", "clay"] and info["num_frames"] == 2
        inst.apply_object_settings("bouncyball", {"adaptor": "clay", "weight": 0.5})
        assert float(inst.objects[0].elasticity.mlp.final.lora_scale) == 0.5
        assert float(inst.objects[1].elasticity.mlp.final.lora_scale) == 4.0
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
