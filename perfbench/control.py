"""Readings that set the check's limits (``limits/<cell>.json``): the
control and the planted faults, at a cell's own size, on several seeds.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... --what <control|half|altered>
        [--seconds <s>]

``control``: the reference put in the program's place, computed in TF32
(the precision below the configurations' float32 with TF32 off), against
the reference in float32. Training cells need no window for it; serving
cells run a short window of the program for the frames to compare and
replace the program's outputs by the TF32 reference's.

``half`` and ``altered``: a full run of the cell (the harness's own run,
its look for a card skipped) with the timed path broken underneath:

* ``half``: training's pixel loss of each frame takes the mean over half
  of the image's rows and leaves the rest out; serving's step moves
  only the first half of the particles;
* ``altered``: training's second leaf's gradient (the first layer's LoRA
  B; A's is nought while B starts at 0) is doubled where the backward
  hands it to the clip; serving's first view gets 0.05 added to
  one 16x16 block of pixels where the rasterizer produces it;
* ``unchanged`` (training, the tests only: it reads 1 by the change's
  measure): the step leaves the leaves as they were.

The benchmark's runs never run this. Prints one JSON line per seed.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch


@contextlib.contextmanager
def planted(kind: str, what: str):
    """Break the port underneath the timed path for the block."""
    rz = importlib.import_module("neuma_tpu_torch.render.rasterize")  # the package exports the function
    rollout = importlib.import_module("neuma_tpu_torch.sim.rollout")
    grounding = importlib.import_module("neuma_tpu_torch.train.grounding")

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if kind == "train" and what == "unchanged":
        patch(grounding, "apply_updates", lambda params, updates: None)
    elif kind == "train" and what == "half":
        losses = dict(grounding.PIXEL_LOSSES)
        patch(grounding, "PIXEL_LOSSES",
              {k: (lambda f: lambda p, g: f(p[..., ::2, :], g[..., ::2, :]))(f)
               for k, f in losses.items()})
    elif kind == "train" and what == "altered":
        real = grounding._sum_over_ranks

        def doubled(scene, grads):
            out = real(scene, grads)
            return [out[0], out[1] * 2.0] + list(out[2:])

        patch(grounding, "_sum_over_ranks", doubled)
    elif kind == "serve" and what == "half":
        real_make = rollout.make_step_fn

        def make_half(constants, statics, e, p, diff=True):
            step = real_make(constants, statics, e, p, diff)

            def half(state, sort=None):
                new = step(state, sort)
                n = state.x.shape[0] // 2
                keep = lambda a, b: torch.cat([a[:n], b[n:]])
                return type(state)(keep(new.x, state.x), keep(new.v, state.v),
                                   keep(new.C, state.C), keep(new.F, state.F))

            return half

        patch(rollout, "make_step_fn", make_half)
    elif kind == "serve" and what == "altered":
        real_r = rz.rasterize_with_aux
        first = {}

        def altered(means3d, cov, opacity, camera, bg, **kw):
            img, aux = real_r(means3d, cov, opacity, camera, bg, **kw)
            if first.setdefault("cam", id(camera)) == id(camera):
                img = img.clone()
                img[:, :16, :16] += 0.05
            return img, aux

        patch(rz, "rasterize_with_aux", altered)
    else:
        raise ValueError(f"no fault {what!r} for {kind} cells")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def control_train(raw, cfg, steps: int) -> dict:
    from perfbench import check, reference

    ref = reference.train(raw, cfg, steps)
    low = reference.train(raw, cfg, steps, tf32=True)
    prog = {"losses": low["losses"], "snaps": {0: low["leaves0"], steps: low["leaves"]},
            "first_grads": low["first_grads"]}
    return check.train_numbers(prog, ref)


def main(argv) -> int:
    from perfbench import check, harness, inputs, program, reference

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", choices=("control", "half", "altered", "unchanged"), required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    manifest = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    _, cfg, traffic = harness.find_cell(manifest, args.workload)
    kind = traffic["kind"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.what == "control" and kind == "train":
            raw = inputs.make(cfg, seed, device, with_gt=True,
                              lora_b_std=float(traffic["lora_b_std"]))
            numbers = control_train(raw, cfg, int(traffic["checked_steps"]))
        elif args.what == "control":
            raw = inputs.make(cfg, seed, device, with_gt=False,
                              lora_b_std=float(traffic["lora_b_std"]))
            scene = program.build_scene(cfg, raw, device)
            sample = list(range(int(traffic["checked_frames"])))
            win = program.serve(cfg, traffic, raw, scene, args.seconds, None, device,
                                lambda: None, sample)
            del scene

            def stand_in(pre, ref):
                return reference.frame_step(raw, cfg, pre, tf32=True, ref=ref)

            numbers = check.serve_numbers(win.checked["frames"], win.checked["host"], raw, cfg,
                                          stand_in=stand_in)
        else:
            with planted(kind, args.what):
                res = harness.run(args.workload, seed, args.seconds, False, device, t0, manifest)
            numbers = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = __file__.rsplit("/perfbench/", 1)[0]
    sys.exit(main(sys.argv[1:]))
