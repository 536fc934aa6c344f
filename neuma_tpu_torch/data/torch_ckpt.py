"""Reference checkpoints into the port's parameter trees, and the npz
parameter format of both packages.

Counterpart of ``neuma_tpu/data/torch_ckpt.py`` (``load_torch_file``,
``mlp_params_from_state_dict``, ``load_base_model``,
``merge_lora_state_dict``, ``save_params_npz``, ``load_params_npz``).

Reference formats:
* Base models ``{jelly,plasticine,sand}_0300.pt``: a dict with keys
  'elasticity' / 'plasticity', each a torch state_dict of the
  InvariantFullMeta nets: ``layers.{i}.fc.weight`` (out, in) [+ .bias,
  or weight norm as 'weight_g'/'weight_v' or the parametrize API's
  'parametrizations.weight.original0/1'], ``final_layer.fc.weight``.
* LoRA checkpoints ``{epoch}_lora.pt``: 'elasticity' / 'plasticity' /
  'loss', each holding ``...fc.lora_A`` (r, in) and ``...fc.lora_B``
  (out, r).

The port's layout (``nn/mlp.py``): kernel (in, out) = W.T, lora_a
(in, r) = A.T, lora_b (r, out) = B.T; leaves are float32 CPU tensors.
The npz format keys each leaf by its /-joined path (``layers/0/kernel``),
so a file written by either package loads in the other.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _leaf(t) -> torch.Tensor:
    return torch.as_tensor(np.array(torch.as_tensor(t).detach().cpu(), np.float32))


def load_torch_file(path) -> Dict:
    """Reference checkpoints are full pickles (not weights-only)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def mlp_params_from_state_dict(sd: Dict, num_layers: int) -> Dict:
    """One InvariantFullMeta net's state_dict -> the port's MLP tree
    (plain Linear, bias and both weight-norm forms, LoRA A/B)."""

    def linear(prefix: str) -> Dict:
        p: Dict = {}
        if f"{prefix}.weight_v" in sd:
            v, g = sd[f"{prefix}.weight_v"], sd[f"{prefix}.weight_g"]
        elif f"{prefix}.parametrizations.weight.original1" in sd:
            v = sd[f"{prefix}.parametrizations.weight.original1"]
            g = sd[f"{prefix}.parametrizations.weight.original0"]
        else:
            v = g = None
        if v is not None:
            # torch stores (out, in) with the norm over the in dim per out row
            p["kernel_v"] = _leaf(v).T.contiguous()
            p["kernel_g"] = _leaf(g).reshape(1, -1)
        else:
            p["kernel"] = _leaf(sd[f"{prefix}.weight"]).T.contiguous()
        if f"{prefix}.bias" in sd:
            p["bias"] = _leaf(sd[f"{prefix}.bias"])
        if f"{prefix}.lora_A" in sd:
            p["lora_a"] = _leaf(sd[f"{prefix}.lora_A"]).T.contiguous()
            p["lora_b"] = _leaf(sd[f"{prefix}.lora_B"]).T.contiguous()
        return p

    return {
        "layers": [linear(f"layers.{i}.fc") for i in range(num_layers)],
        "final": linear("final_layer.fc"),
    }


def load_base_model(path, num_layers: int = 2):
    """A pretrained NCLaw pair -> (elasticity tree, plasticity tree)."""
    ckpt = load_torch_file(path)
    return (
        mlp_params_from_state_dict(ckpt["elasticity"], num_layers),
        mlp_params_from_state_dict(ckpt["plasticity"], num_layers),
    )


def merge_lora_state_dict(params: Dict, sd: Dict, num_layers: int, r: int, alpha: float) -> Dict:
    """Overlay a reference LoRA state_dict onto a base tree (a copy)."""
    scale = torch.tensor(alpha / r, dtype=torch.float32)

    def overlay(p: Dict, prefix: str) -> Dict:
        p = dict(p)
        if f"{prefix}.lora_A" in sd:
            p["lora_a"] = _leaf(sd[f"{prefix}.lora_A"]).T.contiguous()
            p["lora_b"] = _leaf(sd[f"{prefix}.lora_B"]).T.contiguous()
            p["lora_scale"] = scale.clone()
        return p

    return {
        "layers": [overlay(params["layers"][i], f"layers.{i}.fc") for i in range(num_layers)],
        "final": overlay(params["final"], "final_layer.fc"),
    }


def save_params_npz(path, params: Dict) -> None:
    """A nested tree (dicts, lists, tensors, numpy or scalars) as one npz
    keyed by /-joined paths."""
    flat = {}

    def walk(p, prefix):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(v, f"{prefix}/{i}")
        elif isinstance(p, torch.Tensor):
            flat[prefix] = p.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(p)

    walk(params, "")
    np.savez(path, **flat)


def load_params_npz(path) -> Dict:
    """Inverse of ``save_params_npz`` with tensor leaves (a level whose
    keys are all integers is a list)."""
    data = np.load(path)
    tree: Dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(data[key])

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)
