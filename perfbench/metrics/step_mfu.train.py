"""The whole training frame's share of the card's peak (layer: device)."""
from perfbench.metrics._step import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(ctx, bwd_factor=3.0, substeps=int(ctx.cfg["sim"]["substeps"]))
