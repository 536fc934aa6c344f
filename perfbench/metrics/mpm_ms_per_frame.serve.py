"""Milliseconds of the traced frames charged to the MPM step (``mpm.*``),
per served frame (layer: MPM step)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "serve", "mpm", ctx.trace["frames"])
