"""K4/K5's share of their roofline, train cells (layer: kernels)."""
from perfbench.metrics._composite import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(ctx)
