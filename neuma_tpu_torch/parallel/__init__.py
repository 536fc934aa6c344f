"""Multi-process entry (counterpart of ``neuma_tpu/parallel``)."""
