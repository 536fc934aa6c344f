"""Milliseconds of the traced epoch charged to the binding and the
rasterizer (``binding.*``, ``raster.*``: every view's forward, recompute and
backward), per trained frame (layer: rasterizer)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "train", "render", ctx.trace["frames"])
