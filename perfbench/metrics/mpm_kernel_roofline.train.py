"""K1-K3's share of their roofline, train cells (layer: kernels)."""
from perfbench.metrics._mpm import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(ctx)
