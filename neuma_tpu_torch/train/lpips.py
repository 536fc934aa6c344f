"""LPIPS-VGG perceptual metric.

Counterpart of ``neuma_tpu/train/lpips.py`` (``VGG16_STAGES``, the
scaling constants, ``LPIPSParams``, ``_init_random``,
``load_lpips_params``, ``export_torch_lpips_to_npz``, ``_vgg_features``,
``_unit_normalize``, ``lpips``, ``LPIPSMetric``), the LPIPS v0.1
architecture (Zhang et al., CVPR 2018):

* input scaling ``(x*2-1 - shift) / scale`` with the published constants;
* torchvision-layout VGG16 (3x3 convolutions with padding 1 and ReLU,
  2x2 max-pooling that drops an odd edge) tapped at relu1_2, relu2_2,
  relu3_3, relu4_3 and relu5_3;
* per-tap channel unit normalization (the epsilon outside the sqrt),
  squared difference, non-negative 1x1 linear heads, spatial mean, sum
  over taps.

Weights, in order: an ``lpips_vgg.npz`` next to this file (made with
``export_torch_lpips_to_npz`` where the ``lpips`` package and its
weights are installed; none ships), a user-supplied npz, or the
deterministic random-VGG fallback labelled ``lpips_vgg_rand``. The
fallback draws the same numpy ``default_rng(seed)`` values in the same
order as the JAX package, so both give the same distance.

The convolutions run under ``losses.exact_conv`` (TF32 off) on the card.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .losses import exact_conv

# VGG16: (out_channels, n_convs) per stage; taps after the last ReLU of each.
VGG16_STAGES: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 3), (512, 3), (512, 3),
)

# The LPIPS scaling layer's constants (lpips/lpips.py ScalingLayer).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

VENDORED_WEIGHTS = Path(__file__).resolve().parent / "lpips_vgg.npz"


@dataclasses.dataclass
class LPIPSParams:
    convs: List[Tuple[torch.Tensor, torch.Tensor]]  # [(OIHW kernel, bias)]
    heads: List[torch.Tensor]  # [(C,) non-negative linear weights] per tap
    pretrained: bool

    @classmethod
    def from_numpy(cls, convs, heads, pretrained: bool, device="cpu") -> "LPIPSParams":
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
        return cls(convs=[(f32(w), f32(b)) for w, b in convs],
                   heads=[f32(h).reshape(-1) for h in heads], pretrained=pretrained)


def _init_random(seed: int = 0, device="cpu") -> LPIPSParams:
    """Deterministic Kaiming-style random VGG and uniform heads."""
    rng = np.random.default_rng(seed)
    convs = []
    c_in = 3
    for c_out, n in VGG16_STAGES:
        for _ in range(n):
            fan_in = c_in * 9
            w = rng.normal(0.0, np.sqrt(2.0 / fan_in), (c_out, c_in, 3, 3)).astype(np.float32)
            convs.append((w, np.zeros(c_out, np.float32)))
            c_in = c_out
    heads = [np.full(c, 1.0 / c, np.float32) for c, _ in VGG16_STAGES]
    return LPIPSParams.from_numpy(convs, heads, pretrained=False, device=device)


def load_lpips_params(path: Optional[Path] = None, device="cpu") -> LPIPSParams:
    """npz layout: conv{i}_w (OIHW), conv{i}_b, head{j}_w (C,). The
    random fallback when the file is absent."""
    p = Path(path) if path is not None else VENDORED_WEIGHTS
    if not p.is_file():
        return _init_random(device=device)
    d = np.load(p)
    convs = [(d[f"conv{i}_w"], d[f"conv{i}_b"])
             for i in range(sum(n for _, n in VGG16_STAGES))]
    heads = [d[f"head{j}_w"] for j in range(len(VGG16_STAGES))]
    return LPIPSParams.from_numpy(convs, heads, pretrained=True, device=device)


def export_torch_lpips_to_npz(out_path) -> None:
    """Offline converter: run where the ``lpips`` package (and its
    pretrained weights) is installed, then put the npz next to this file.
    Maps ``lpips.LPIPS(net='vgg')``'s state to the npz layout above."""
    import lpips as lpips_pkg  # optional dependency

    model = lpips_pkg.LPIPS(net="vgg")
    net = model.net
    arrays = {}
    i = 0
    for sl in (net.slice1, net.slice2, net.slice3, net.slice4, net.slice5):
        for layer in sl:
            if isinstance(layer, torch.nn.Conv2d):
                arrays[f"conv{i}_w"] = layer.weight.detach().cpu().numpy()
                arrays[f"conv{i}_b"] = layer.bias.detach().cpu().numpy()
                i += 1
    for j, lin in enumerate(model.lins):
        arrays[f"head{j}_w"] = lin.model[-1].weight.detach().cpu().numpy().reshape(-1)
    np.savez(out_path, **arrays)


def _vgg_features(params: LPIPSParams, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W) already scaled. Returns the 5 tapped maps."""
    taps = []
    i = 0
    with exact_conv():
        for si, (_, n) in enumerate(VGG16_STAGES):
            if si > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                w, b = params.convs[i]
                x = torch.relu(F.conv2d(x, w, b, padding=1))
                i += 1
            taps.append(x)
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips(img0: torch.Tensor, img1: torch.Tensor, params: LPIPSParams) -> torch.Tensor:
    """LPIPS distance per batch element; images (N, 3, H, W) or (3, H, W)
    in [0, 1] (torchmetrics' ``normalize=True`` convention)."""
    if img0.ndim == 3:
        img0, img1 = img0[None], img1[None]
    shift = torch.as_tensor(_SHIFT, device=img0.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=img0.device)[None, :, None, None]
    x0 = (img0 * 2.0 - 1.0 - shift) / scale
    x1 = (img1 * 2.0 - 1.0 - shift) / scale
    total = 0.0
    for tap0, tap1, head in zip(_vgg_features(params, x0), _vgg_features(params, x1),
                                params.heads):
        d = (_unit_normalize(tap0) - _unit_normalize(tap1)) ** 2
        total = total + torch.mean(torch.sum(d * head[None, :, None, None], dim=1), dim=(1, 2))
    return total


class LPIPSMetric:
    """Weight resolution and a callable on (3, H, W) images, held on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, weights_path: Optional[Path] = None, device=None):
        self.device = resolve_device(device)
        self.params = load_lpips_params(weights_path, self.device)
        self.name = "lpips_vgg" if self.params.pretrained else "lpips_vgg_rand"
        if not self.params.pretrained:
            print(
                "WARNING: no pretrained LPIPS-VGG weights found "
                f"(looked for {weights_path or VENDORED_WEIGHTS}); using "
                "the deterministic random-VGG fallback. The metric is "
                "reported as 'lpips_vgg_rand' — vendor real weights via "
                "neuma_tpu_torch.train.lpips.export_torch_lpips_to_npz for the "
                "reference protocol."
            )

    def __call__(self, img0, img1) -> float:
        a = torch.as_tensor(np.asarray(img0, np.float32), device=self.device)
        b = torch.as_tensor(np.asarray(img1, np.float32), device=self.device)
        with torch.no_grad():
            return float(torch.mean(lpips(a, b, self.params)))
