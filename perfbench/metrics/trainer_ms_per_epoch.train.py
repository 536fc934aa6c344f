"""Milliseconds of the traced epoch (one is traced) charged to the optimizer
step and the host reads (``train.optim``, ``train.read``) (layer: trainer)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "train", "trainer", 1)
