"""Share of the traced frames' wall charged to no span of the port (layer:
host dispatch)."""
from perfbench.metrics._spans import untraced_share


def read(ctx):
    return untraced_share(ctx, "serve")
