"""Milliseconds of the traced frames charged to the binding and the
rasterizer (``binding.*``, ``raster.*``), per served view (layer:
rasterizer)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "serve", "render", ctx.trace["frames"] * len(ctx.cfg["views"]))
