"""Config and logging helpers (counterpart of ``neuma_tpu/utils``)."""
from .config import Config, load_config
from .logging import AverageMeter, Logger, Timer

__all__ = [
    "Config",
    "load_config",
    "Logger",
    "Timer",
    "AverageMeter",
]
