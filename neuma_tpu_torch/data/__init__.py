"""Dataset readers, particle sampling and data preparation (counterpart of ``neuma_tpu/data``)."""
