"""Interactive viewer (counterpart of ``neuma_tpu/vis``)."""
from .instance import NeuMAInstance
from .viewer import DynamicViewer

__all__ = ["NeuMAInstance", "DynamicViewer"]
