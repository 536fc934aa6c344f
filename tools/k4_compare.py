"""K4 of two trees on the same deep views, for a before/after comparison on
the card.

    python3 tools/k4_compare.py make <dir>          # fabricate the views, save K4's inputs
    python3 tools/k4_compare.py time <tree> <dir>   # time <tree>'s K4 on them

``make`` fabricates two balls of 10,000 Gaussians with this tree's
``chip_smoke.fabricate_ball`` and saves K4's inputs (pair features, tile
ranges) of two views: both balls in the viewer's 640x640 view, and one
ball in an 800x800 view. ``time`` imports ``chip_smoke`` and the port
from ``<tree>`` (a ``git archive`` of another commit, or this one), holds
its K4 against its plain version on those inputs and times it (CUDA
events over 50 calls, and the device time of each kernel under
``torch.profiler``), and prints one JSON line with the card's name and
power limit. Where ``<tree>``'s wrapper counts K4's pixels on the plain
walk (``with_exact``), the line has that count too. Run each tree in its
own process, in the order parent, change, change, parent, in one call.
"""
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch


def make(out: Path):
    import chip_smoke as cs
    from neuma_tpu_torch.render.camera import Camera
    from neuma_tpu_torch.render.gaussians import GaussianPack
    from neuma_tpu_torch.render.rasterize import RasterConfig

    packs = []
    for i in range(2):
        cs.fabricate_ball(out / f"b{i}", 10000, seed=10 + i, device="cuda")
        packs.append(GaussianPack.from_ply(out / f"b{i}" / "kernels.ply", 3, device="cuda"))
    views = {
        "view640_two_balls": (GaussianPack.concatenate(packs), cs.view_camera(0, 640, "cuda")),
        "app800_one_ball": (packs[0], Camera.look_at(
            eye=np.array([0.0, 0.6, -1.5]), target=np.array([0.0, 0.45, 0.0]), fov=0.8,
            width=800, height=800, device="cuda")),
    }
    gen = torch.Generator().manual_seed(0)
    saved = {}
    with torch.no_grad():
        for name, (pack, cam) in views.items():
            inp = cs.regist_kernel_inputs(pack, cam, RasterConfig(max_pairs=262144), gen)
            saved[name] = {k: inp[k] for k in ("pf", "tile_start", "counts", "tiles_x")}
            print(json.dumps(dict(view=name, pairs=int(inp["counts"].sum()),
                                  deepest_tile=int(inp["counts"].max()),
                                  overflow=bool(inp["raster_overflow"]))), flush=True)
    torch.save(saved, out / "inputs.pt")


def time_tree(tree: Path, out: Path):
    import chip_smoke as cs
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.render import raster_kernel as rk

    kernels.library()
    counts_exact = "with_exact" in inspect.signature(rk.composite_fwd).parameters
    res = {}
    for name, inp in torch.load(out / "inputs.pt").items():
        args = (inp["pf"], inp["tile_start"], inp["counts"], inp["tiles_x"])
        got = rk.composite_fwd(*args, with_exact=True) if counts_exact else rk.composite_fwd(*args)
        Tp, Cp, lp = rk.composite_fwd_plain(*args)
        T, C, last = got[:3]
        res[name] = dict(
            max_abs_err=max(float((T - Tp).abs().max()), float((C - Cp).abs().max())),
            last_mismatch=int((last != lp).sum()),
            exact_walk_pixels=int(got[3].sum()) if counts_exact else None,
            ms=cs.cuda_ms(lambda: rk.composite_fwd(*args), 50),
            device_ms=cs.device_rows(lambda: rk.composite_fwd(*args)))
    print(json.dumps(dict(tree=str(tree), nvidia_smi=cs.nvidia_smi(), k4=res)), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    tree = Path(sys.argv[2]).resolve() if mode == "time" else Path(__file__).resolve().parent.parent
    out = Path(sys.argv[-1]).resolve()
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(tree))
    if mode == "make":
        make(out)
    else:
        time_tree(tree, out)
