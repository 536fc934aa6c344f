"""K4/K5's share of their roofline, serve cells (layer: kernels)."""
from perfbench.metrics._composite import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx)
