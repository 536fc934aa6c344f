"""Command-line apps (counterpart of ``neuma_tpu/apps``)."""
