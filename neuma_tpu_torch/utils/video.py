"""Video and GIF packing of saved frames.

Counterpart of ``neuma_tpu/utils/video.py`` (``_natsorted``,
``_load_frames``, ``save_video``, ``save_gif``). Frames are written
through ``imageio`` where it is installed: an mp4 when its ffmpeg plugin
works, else the GIF the JAX package falls back to. Where ``imageio`` is
not installed the same GIF (every frame, ``1000 / fps`` ms each, looping)
is written by PIL, and the printed line says so.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


def _load_frames(frame_dir, frame_glob, skip_frame, white_bg, resize=None):
    """Every ``skip_frame``-th frame in natural order as (H, W, 3) uint8;
    RGBA frames are composited over the background."""
    from PIL import Image

    paths = _natsorted(Path(frame_dir).glob(frame_glob))[::skip_frame]
    frames = []
    bg = np.array([1, 1, 1]) if white_bg else np.array([0, 0, 0])
    for p in paths:
        image = Image.open(p)
        if resize is not None:
            image = image.resize(resize)
        if image.mode == "RGBA":
            rgba = np.array(image) / 255.0
            rgb = rgba[:, :, :3] * rgba[:, :, 3:] + (1 - rgba[:, :, 3:]) * bg
            frames.append((rgb * 255).astype(np.uint8))
        else:
            frames.append(np.array(image.convert("RGB")))
    return frames


def _imageio():
    """The ``imageio`` module, or None where it is not installed."""
    try:
        import imageio
    except ImportError:
        return None
    return imageio


def _pil_gif(output_path, frames, fps: int) -> None:
    from PIL import Image

    images = [Image.fromarray(f) for f in frames]
    images[0].save(output_path, save_all=True, append_images=images[1:],
                   duration=1000.0 / fps, loop=0)


def save_video(
    frame_dir,
    frame_glob: str,
    output_path,
    skip_frame: int = 1,
    fps: int = 30,
    white_bg: bool = False,
) -> Path:
    """Pack the frames into ``output_path`` (an mp4) or, where that cannot
    be written, a GIF beside it. Returns the path written (None when no
    frame matched)."""
    frames = _load_frames(frame_dir, frame_glob, skip_frame, white_bg)
    if not frames:
        print(f"No frames matching {frame_glob} in {frame_dir}")
        return None
    imageio = _imageio()
    if imageio is None:
        output_path = Path(output_path).with_suffix(".gif")
        _pil_gif(output_path, frames, fps)
        print(f"Video saved to {output_path} (skip {skip_frame}, fps {fps}; "
              "imageio is not installed: GIF written by PIL)")
        return output_path
    try:
        imageio.mimsave(output_path, frames, fps=fps)
    except Exception:
        # the ffmpeg plugin may be unavailable: fall back to GIF
        output_path = Path(output_path).with_suffix(".gif")
        imageio.mimsave(output_path, frames, duration=1.0 / fps, loop=0)
    print(f"Video saved to {output_path} (skip {skip_frame}, fps {fps})")
    return Path(output_path)


def save_gif(
    frame_dir,
    frame_glob: str,
    output_path,
    skip_frame: int = 1,
    fps: int = 30,
    white_bg: bool = False,
    resize: Optional[Tuple[int, int]] = None,
) -> None:
    frames = _load_frames(frame_dir, frame_glob, skip_frame, white_bg, resize)
    imageio = _imageio()
    if imageio is None:
        _pil_gif(output_path, frames, fps)
        print(f"GIF saved to {output_path} (imageio is not installed: written by PIL)")
        return
    imageio.mimsave(output_path, frames, duration=1.0 / fps, loop=0)
    print(f"GIF saved to {output_path}")
