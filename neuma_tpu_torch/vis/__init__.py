"""Interactive viewer (counterpart of ``neuma_tpu/vis``)."""
