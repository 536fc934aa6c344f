"""Dataset readers: NeuMA-Synthetic (JSON camera meta + RGBA frames) and
RealCapture (COLMAP intrinsics + calib JSON + dynamic frames + masks).

Counterpart of ``neuma_tpu/data/readers.py`` (``FrameRecord``, the two
camera readers, ``_composite_rgba``, ``_downscale_record`` and
``VideoDataset``), the same numpy code with the port's ``Camera``.
Frames stay numpy (3, H, W) float32 on the host; ``stacked_gt`` gives
the training stack as a tensor on the device asked for.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from ..render.camera import Camera, focal2fov
from .colmap import read_cameras_binary, read_cameras_text, rodrigues


@dataclasses.dataclass
class FrameRecord:
    """One (view, step) observation."""

    view: str
    step: int
    camera: Camera
    image: np.ndarray  # (3, H, W) float32 in [0, 1], bg-composited


def _composite_rgba(im_data: np.ndarray, bg: np.ndarray) -> np.ndarray:
    norm = im_data.astype(np.float64) / 255.0
    rgb = norm[:, :, :3] * norm[:, :, 3:4] + bg * (1 - norm[:, :, 3:4])
    return rgb.astype(np.float32)


def _scan_views_steps(folder, used_views, exclude_steps):
    views, steps = set(), set()
    for d in os.listdir(folder):
        view = str(d.rsplit("_", 1)[0])
        if used_views is None or view in used_views:
            views.add(view)
        step = int(d.rsplit("_", 1)[1].split(".")[0])
        if step not in exclude_steps:
            steps.add(step)
    return sorted(views), sorted(steps)


def read_neuma_synthetic_cameras(
    path,
    transformsfile: str,
    white_background: bool,
    extension: str = ".png",
    init_frame: Optional[int] = None,
    exclude_steps: Sequence[int] = (-1,),
    used_views: Optional[Sequence[str]] = None,
    **_unused,
) -> Dict:
    """Reference dataset_readers.py:200-276: JSON with per-file c2w
    (OpenGL axes -> COLMAP flip on columns 1:2) + intrinsics; RGBA frames
    composited over the background."""
    from PIL import Image

    path = Path(path)
    subfolder = transformsfile.split(".")[0]
    views, steps = _scan_views_steps(
        path / subfolder, used_views, list(exclude_steps)
    )
    bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])

    with open(path / transformsfile) as f:
        contents = json.load(f)
    meta = {entry.pop("file_path"): entry for entry in contents}

    use_steps = [init_frame] if init_frame is not None else steps
    records: List[FrameRecord] = []
    for view in views:
        for step in use_steps:
            key = f"./{subfolder}/{view}_{step:03d}{extension}"
            assert key in meta, f"File {key} not found in transforms meta"
            c2w = np.array(meta[key]["c2w"], np.float64)
            if c2w.shape[0] == 3:
                c2w = np.concatenate(
                    [c2w, np.array([[0, 0, 0, 1.0]])], axis=0
                )
            # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward).
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]

            img = Image.open(path / key[2:])
            im_data = np.array(img.convert("RGBA"))
            rgb = _composite_rgba(im_data, bg)
            h, w = rgb.shape[:2]

            intr = meta[key]["intrinsic"]
            fov_x = focal2fov(intr[0][0], w)
            fov_y = focal2fov(intr[1][1], h)
            cam = Camera.from_Rt(R, T, fov_x, fov_y, w, h)
            records.append(
                FrameRecord(
                    view=view,
                    step=step,
                    camera=cam,
                    image=rgb.transpose(2, 0, 1),
                )
            )
    return {"records": records, "views": views, "steps": use_steps}


def read_real_capture_cameras(
    path,
    white_background: bool,
    extension: str = ".jpg",
    width: int = 1920,
    height: int = 1080,
    init_frame: Optional[int] = None,
    exclude_steps: Sequence[int] = (-1,),
    used_views: Optional[Sequence[str]] = None,
    read_mask_only: bool = False,
    **_unused,
) -> Dict:
    """Reference dataset_readers.py:279-365: COLMAP binary intrinsics
    rescaled from the 4752x2672 capture resolution, cameras_calib.json
    Rodrigues extrinsics per view, dynamic frames composited with masks
    (or mask-only silhouettes)."""
    from PIL import Image

    path = Path(path)
    cam_file = path / "sparse" / "0" / "cameras.bin"
    if cam_file.is_file():
        intrinsics = read_cameras_binary(cam_file)
    else:
        intrinsics = read_cameras_text(
            path / "sparse" / "0" / "cameras.txt"
        )
    params = intrinsics[1].params
    fx = params[0] * width / 4752
    fy = params[1] * height / 2672
    fov_y = focal2fov(fx, height)  # matches reference's (quirky) pairing
    fov_x = focal2fov(fy, width)   # (dataset_readers.py:300-307)

    with open(path / "cameras_calib.json") as f:
        cam_calib = json.load(f)

    views, steps = _scan_views_steps(
        path / "dynamics", used_views, list(exclude_steps)
    )
    use_steps = [init_frame] if init_frame is not None else steps
    bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])

    records: List[FrameRecord] = []
    for view in views:
        rot = rodrigues(np.array(cam_calib[view]["rvecs"]))
        R = np.transpose(rot)
        T = np.array(cam_calib[view]["tvecs"]).reshape(3)
        cam = Camera.from_Rt(R, T, fov_x, fov_y, width, height)
        for step in use_steps:
            image_name = path / "dynamics" / f"{view}_{step}{extension}"
            mask_name = (
                path / "dynamic_masks" / f"{view}_{step}.png"
            )
            if read_mask_only:
                mask = np.array(Image.open(mask_name))
                rgb = np.repeat(
                    mask[:, :, None], 3, axis=-1
                ).astype(np.float32) / 255.0
            else:
                im_data = np.array(Image.open(image_name))
                mask = (
                    np.array(Image.open(mask_name))[:, :, None] / 255.0
                )
                rgb = (
                    (im_data / 255.0) * mask + bg * (1 - mask)
                ).astype(np.float32)
            records.append(
                FrameRecord(
                    view=view,
                    step=step,
                    camera=cam,
                    image=rgb.transpose(2, 0, 1),
                )
            )
    return {"records": records, "views": views, "steps": use_steps}


READERS = {
    "NeuMASynthetic": read_neuma_synthetic_cameras,
    "RealCapture": read_real_capture_cameras,
}


def _downscale_record(r: FrameRecord, res: int) -> FrameRecord:
    """Downscale image + camera by an integer divisor."""
    from PIL import Image

    h, w = r.image.shape[1], r.image.shape[2]
    nw, nh = w // res, h // res
    img = Image.fromarray(
        (r.image.transpose(1, 2, 0) * 255).astype(np.uint8)
    ).resize((nw, nh))
    arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    cam = Camera(
        world_view=r.camera.world_view,
        full_proj=r.camera.full_proj,
        camera_center=r.camera.camera_center,
        width=nw,
        height=nh,
        fov_x=r.camera.fov_x,
        fov_y=r.camera.fov_y,
        znear=r.camera.znear,
        zfar=r.camera.zfar,
    )
    return FrameRecord(view=r.view, step=r.step, camera=cam, image=arr)


class VideoDataset:
    """Cameras + GT frames indexed by (view, step) (reference
    ``VideoDataset``, neuma_dataset.py:76-153; the trainable initial
    state is the stage-1 optimizer's in train/grounding.py).

    ``cfg['camera']['resolution']`` is the integer downscale divisor
    (reference camera_utils resolution handling)."""

    def __init__(self, cfg: dict):
        camera_type = cfg["camera_type"]
        read_fn = READERS[camera_type]
        info = read_fn(**cfg["data"])
        self.views: List[str] = info["views"]
        self.steps: List[int] = info["steps"]
        self.records: List[FrameRecord] = info["records"]

        res = int(cfg.get("camera", {}).get("resolution", 1) or 1)
        if res > 1:
            self.records = [
                _downscale_record(r, res) for r in self.records
            ]
        self._by_key = {
            (r.view, r.step): r for r in self.records
        }

    def get(self, view, step) -> FrameRecord:
        if isinstance(view, int):
            view = self.views[view]
        return self._by_key[(view, step)]

    def __len__(self) -> int:
        return len(self.records)

    def stacked_gt(
        self, used_views: Sequence[str], frame_steps: Sequence[int], device="cpu"
    ) -> torch.Tensor:
        """(n_frames, n_views, 3, H, W) float32 on ``device``: rollout
        frame f renders against dataset step frame_steps[f]."""
        stack = np.stack(
            [
                np.stack(
                    [self.get(v, s).image for v in sorted(used_views)]
                )
                for s in frame_steps
            ]
        )
        return torch.as_tensor(stack, dtype=torch.float32, device=device)

    def cameras_for(self, used_views: Sequence[str]) -> List[Camera]:
        step0 = self.steps[0]
        return [self.get(v, step0).camera for v in sorted(used_views)]
