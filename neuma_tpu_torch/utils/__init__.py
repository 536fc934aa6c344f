"""Config and logging helpers (counterpart of ``neuma_tpu/utils``)."""
