"""Share of the step layouts' refreshes in the traced frames that rebuilt
the block sort (layer: MPM step)."""
from perfbench.metrics._spans import rebuild_share


def read(ctx):
    return rebuild_share(ctx, "serve")
