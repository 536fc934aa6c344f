"""Milliseconds of the traced epoch charged to the materials
(``material.*``), per trained frame (layer: material)."""
from perfbench.metrics._spans import ms


def read(ctx):
    return ms(ctx, "train", "material", ctx.trace["frames"])
