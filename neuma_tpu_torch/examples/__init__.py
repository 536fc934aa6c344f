"""Runnable examples of the port (``python -m neuma_tpu_torch.examples.<name>``)."""
