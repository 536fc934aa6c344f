"""Milliseconds of the traced epoch charged to the MPM step (``mpm.*``), per
trained frame (layer: MPM step)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "train", "mpm", ctx.trace["frames"])
