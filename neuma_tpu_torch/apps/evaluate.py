"""Image-quality evaluation CLI: PSNR, SSIM and LPIPS over rendered and
ground-truth frames with the reference's centre-crop protocol, and a
side-by-side comparison video.

Counterpart of ``neuma_tpu/apps/evaluate.py`` and of the reference's
``experiments/evaluation.py``: metrics on the crop [220:580]^2 of 800^2
renders (applied only to images larger than the crop), every ``skip``
frames, written to ``metrics.txt`` in the JAX app's format. Usage:

    python -m neuma_tpu_torch.apps.evaluate -r <render_dir> -g <gt_dir> \\
        [--render_glob '*.png'] [--gt_glob '*.png'] [-o metrics.txt] [--skip N] \\
        [--crop y0 y1 x0 x1] [--start i] [--end j] [--video]

Images are read on the host; the metrics run on ``device``:
``main(argv, device)`` runs on ``cuda`` unless ``device="cpu"`` is
passed, and without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..train.losses import exact_conv, psnr as psnr_fn, ssim as ssim_fn
from ..utils.video import _natsorted, save_video


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--render_dir", "-r", type=str, required=True)
    p.add_argument("--gt_dir", "-g", type=str, required=True)
    p.add_argument("--render_glob", type=str, default="*.png")
    p.add_argument("--gt_glob", type=str, default="*.png")
    p.add_argument("--output", "-o", type=str, default=None)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--crop", nargs=4, type=int, default=[220, 580, 220, 580],
                   help="y0 y1 x0 x1 center crop (reference evaluation.py:34-35)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=-1)
    p.add_argument("--video", action="store_true")
    return p.parse_args(argv)


def _lpips_model(weights=None, device=None):
    """(name, call on (H, W, 3) numpy images) on ``device``: the official
    ``lpips`` package when it imports and builds (it may need to fetch
    its VGG weights), else the in-tree metric (vendored weights, or the
    labelled random-VGG fallback), in the JAX app's order. Either runs
    its convolutions with TF32 off."""
    device = resolve_device(device)
    try:
        import lpips  # optional official package

        model = lpips.LPIPS(net="vgg").to(device)
    except Exception:
        from ..train.lpips import LPIPSMetric

        metric = LPIPSMetric(weights, device=device)
        return metric.name, lambda r, g: metric(r.transpose(2, 0, 1), g.transpose(2, 0, 1))

    def call(r, g):
        nchw = lambda a: torch.from_numpy(a.transpose(2, 0, 1)[None] * 2 - 1).to(device)
        with torch.no_grad(), exact_conv():
            return float(model(nchw(r), nchw(g)))

    return "lpips", call


def _read_rgb(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def evaluate_frames(render_paths, gt_paths, crop, lpips_model=None, device=None):
    """One row of metrics per frame pair (PSNR and SSIM on ``device``)."""
    device = resolve_device(device)
    lpips_name, lpips_call = lpips_model or ("lpips", None)
    rows = []
    for rp, gp in zip(render_paths, gt_paths):
        r, g = _read_rgb(rp), _read_rgb(gp)
        y0, y1, x0, x1 = crop
        if r.shape[0] > y1 and r.shape[1] > x1:
            r, g = r[y0:y1, x0:x1], g[y0:y1, x0:x1]
        rt = torch.as_tensor(np.ascontiguousarray(r.transpose(2, 0, 1)), device=device)
        gt = torch.as_tensor(np.ascontiguousarray(g.transpose(2, 0, 1)), device=device)
        with torch.no_grad():
            row = {"psnr": float(psnr_fn(rt, gt)), "ssim": float(ssim_fn(rt, gt))}
        if lpips_call is not None:
            row[lpips_name] = lpips_call(r, g)
        rows.append(row)
    return rows


def _side_by_side(render_paths, gt_paths, render_dir: Path):
    """render | gt composites and their video (reference evaluation.py)."""
    from PIL import Image

    sbs_dir = render_dir / "side_by_side"
    sbs_dir.mkdir(exist_ok=True)
    for i, (rp, gp) in enumerate(zip(render_paths, gt_paths)):
        r = Image.open(rp).convert("RGB")
        g = Image.open(gp).convert("RGB")
        combo = Image.new("RGB", (r.width + g.width, r.height))
        combo.paste(r, (0, 0))
        combo.paste(g, (r.width, 0))
        combo.save(sbs_dir / f"sbs_{i:04d}.png")
    return save_video(sbs_dir, "sbs_*.png", render_dir / "side_by_side.mp4")


def main(argv=None, device=None):
    args = parse_args(argv)
    device = resolve_device(device)
    render_paths = _natsorted(Path(args.render_dir).glob(args.render_glob))[:: args.skip]
    gt_paths = _natsorted(Path(args.gt_dir).glob(args.gt_glob))[:: args.skip]
    end = args.end if args.end > 0 else min(len(render_paths), len(gt_paths))
    render_paths = render_paths[args.start : end]
    gt_paths = gt_paths[args.start : end]
    if not render_paths or len(render_paths) != len(gt_paths):
        raise ValueError(f"frame count mismatch: {len(render_paths)} vs {len(gt_paths)}")

    rows = evaluate_frames(render_paths, gt_paths, args.crop, _lpips_model(device=device),
                           device=device)
    if args.video:
        _side_by_side(render_paths, gt_paths, Path(args.render_dir))
    keys = rows[0].keys()
    means = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    out_path = Path(args.output or (Path(args.render_dir) / "metrics.txt"))
    with open(out_path, "w") as f:
        for k, v in means.items():
            f.write(f"{k}: {v:.6f}\n")
        f.write("\nper-frame:\n")
        for i, r in enumerate(rows):
            f.write(f"{i}: " + " ".join(f"{k}={v:.5f}" for k, v in r.items()) + "\n")
    print(" ".join(f"{k}={v:.4f}" for k, v in means.items()))
    print(f"Metrics written to {out_path}")
    return means


if __name__ == "__main__":
    main()
