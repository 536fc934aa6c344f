"""Milliseconds of the traced frames charged to the materials
(``material.*``), per served frame (layer: material)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "serve", "material", ctx.trace["frames"])
