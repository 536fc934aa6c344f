"""Layer stack with LoRA (counterpart of ``neuma_tpu/nn``)."""
from .mlp import (
    MLPConfig,
    add_lora,
    apply_linear,
    apply_mlp,
    get_nonlinearity,
    init_linear,
    init_mlp,
    lora_mask,
    lora_params,
    merge_lora,
)

__all__ = [
    "MLPConfig",
    "init_mlp",
    "apply_mlp",
    "init_linear",
    "apply_linear",
    "add_lora",
    "lora_mask",
    "lora_params",
    "merge_lora",
    "get_nonlinearity",
]
