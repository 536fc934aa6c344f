"""The whole served frame's share of the card's peak: one sim step and
every view, forward only (layer: device)."""
from perfbench.metrics._step import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx, bwd_factor=1.0, substeps=1)
