"""K1-K3's share of their roofline, serve cells (layer: kernels)."""
from perfbench.metrics._mpm import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx)
