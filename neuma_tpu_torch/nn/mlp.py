"""MLP layer stack with LoRA for the material adaptors.

Counterpart of ``neuma_tpu/nn/mlp.py`` (with ``lora_mask`` and
``lora_params``). Parameters are the same nested
trees (``{"layers": [dict, ...], "final": dict}`` with the leaves
``kernel`` or ``kernel_v``/``kernel_g``, ``bias``, ``lora_a``, ``lora_b``
and ``lora_scale``), so ``interop.py`` moves them across leaf by leaf.
``kernel`` is stored (in, out): ``y = x @ kernel``. ``MLP`` is the
``nn.Module`` that holds such a tree as parameters.

* GELU is the exact (erf) form, as ``torch.nn.GELU`` and the JAX package.
* The LoRA term is ``(x @ A) @ B * scale``.
* Only ``lora_a`` / ``lora_b`` are trainable (``lora_mask``, the
  reference's ``mark_only_lora_as_trainable``): ``MLP`` registers every
  other leaf with ``requires_grad=False`` and ``lora_scale`` as a buffer.
* Random init draws from an explicit ``torch.Generator`` on the CPU
  (where the JAX package takes a ``PRNGKey``) and then moves to
  ``device``; the two packages give different numbers from one seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

Params = Dict


def get_nonlinearity(name: Optional[str]) -> Callable:
    if name is None:
        return lambda x: x
    key = name.casefold()
    if key == "relu":
        return torch.relu
    if key == "tanh":
        return torch.tanh
    if key in ("silu", "swish"):
        return torch.nn.functional.silu
    if key == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="none")
    if key == "elu":
        return torch.nn.functional.elu
    raise ValueError(f"unexpected nonlinearity: {name}")


def _uniform(generator, shape, lo, hi, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(device)


def init_linear(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    use_bias: bool,
    weight_norm: bool = False,
    device="cpu",
) -> Params:
    """Xavier-uniform kernel, zero bias; weight norm stores
    ``kernel_v`` and ``kernel_g = ||kernel_v||`` over the input dim."""
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    kernel = _uniform(generator, (in_dim, out_dim), -bound, bound, device)
    p: Params = {}
    if weight_norm:
        p["kernel_v"] = kernel
        p["kernel_g"] = torch.linalg.norm(kernel, dim=0, keepdim=True)
    else:
        p["kernel"] = kernel
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=torch.float32, device=device)
    return p


def _effective_kernel(p: Params) -> torch.Tensor:
    if "kernel_v" in p:
        v = p["kernel_v"]
        return p["kernel_g"] * v / torch.clamp(
            torch.linalg.norm(v, dim=0, keepdim=True), min=1e-12
        )
    return p["kernel"]


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ _effective_kernel(p)
    if "lora_a" in p:
        y = y + (x @ p["lora_a"]) @ p["lora_b"] * p["lora_scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def add_lora(p: Params, generator: torch.Generator, r: int, alpha: float) -> Params:
    """A ~ U(+-1/sqrt(fan_in)), B = 0, scale = alpha / r (a copy)."""
    w = _effective_kernel(p)
    in_dim, out_dim = w.shape
    bound = 1.0 / math.sqrt(in_dim)
    new = dict(p)
    new["lora_a"] = _uniform(generator, (in_dim, r), -bound, bound, w.device)
    new["lora_b"] = torch.zeros((r, out_dim), dtype=w.dtype, device=w.device)
    new["lora_scale"] = torch.tensor(alpha / r, dtype=w.dtype, device=w.device)
    return new


def merge_lora(p: Params) -> Params:
    """Fold LoRA into the base kernel."""
    if "lora_a" not in p:
        return p
    new = dict(p)
    delta = p["lora_a"] @ p["lora_b"] * p["lora_scale"]
    if "kernel_v" in p:
        w = _effective_kernel(p) + delta
        new["kernel_v"] = w
        new["kernel_g"] = torch.linalg.norm(w, dim=0, keepdim=True)
    else:
        new["kernel"] = p["kernel"] + delta
    for k in ("lora_a", "lora_b", "lora_scale"):
        new.pop(k)
    return new


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    out_dim: int
    layer_widths: Sequence[int] = (64, 64)
    norm: Optional[str] = None  # None | 'wn' | 'ln'
    nonlinearity: Optional[str] = "gelu"
    no_bias: bool = True

    @property
    def weight_norm(self) -> bool:
        return self.norm is not None and self.norm.casefold() == "wn"


def init_mlp(cfg: MLPConfig, generator: torch.Generator, device="cpu") -> Params:
    """Hidden layers (norm + nonlinearity) and a linear final layer,
    with the JAX package's bias rules."""
    layers: List[Params] = []
    w_in = cfg.in_dim
    for w_out in cfg.layer_widths:
        if cfg.weight_norm:
            use_bias = not cfg.no_bias
        else:
            use_bias = (not cfg.no_bias) and (cfg.norm is None)
        layers.append(
            init_linear(generator, w_in, w_out, use_bias, cfg.weight_norm, device)
        )
        w_in = w_out
    final = init_linear(generator, w_in, cfg.out_dim, not cfg.no_bias, False, device)
    return {"layers": layers, "final": final}


def _apply_norm(norm: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if norm is None or norm.casefold() == "wn":
        return x
    if norm.casefold() == "ln":
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + 1e-5)
    raise ValueError(f"unexpected norm: {norm}")


def apply_mlp(params: Params, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    act = get_nonlinearity(cfg.nonlinearity)
    for layer in params["layers"]:
        x = act(_apply_norm(cfg.norm, apply_linear(layer, x)))
    return apply_linear(params["final"], x)


def add_lora_to_mlp(
    params: Params, generator: torch.Generator, r: int, alpha: float
) -> Params:
    """LoRA on every linear of the stack, drawn in layer order."""
    return {
        "layers": [add_lora(layer, generator, r, alpha) for layer in params["layers"]],
        "final": add_lora(params["final"], generator, r, alpha),
    }


LORA_LEAVES = ("lora_a", "lora_b")


def lora_mask(params: Params) -> Params:
    """Boolean tree of ``params``' form: True only for the ``lora_a`` /
    ``lora_b`` leaves."""
    return {
        "layers": [{k: k in LORA_LEAVES for k in p} for p in params["layers"]],
        "final": {k: k in LORA_LEAVES for k in params["final"]},
    }


def lora_params(params: Params) -> Params:
    """The tree with only the ``lora_a`` / ``lora_b`` leaves (the
    reference's ``lora_state_dict``)."""
    pick = lambda p: {k: v for k, v in p.items() if k in LORA_LEAVES}
    return {"layers": [pick(p) for p in params["layers"]], "final": pick(params["final"])}


class _Linear(nn.Module):
    """One linear's leaves: ``lora_scale`` is a buffer, the rest parameters,
    of which only the LoRA leaves require grad."""

    def __init__(self, p: Params):
        super().__init__()
        self.names = tuple(p)
        for k, v in p.items():
            if k == "lora_scale":
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=k in LORA_LEAVES))

    def tree(self) -> Params:
        return {k: getattr(self, k) for k in self.names}


class MLP(nn.Module):
    """An ``nn.Module`` holding a parameter tree of :func:`init_mlp`'s form."""

    def __init__(self, cfg: MLPConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([_Linear(p) for p in params["layers"]])
        self.final = _Linear(params["final"])

    def tree(self) -> Params:
        return {
            "layers": [layer.tree() for layer in self.layers],
            "final": self.final.tree(),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.tree(), self.cfg, x)
