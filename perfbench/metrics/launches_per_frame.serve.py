"""Kernel launches the card ran per served frame in the traced frames (layer: host dispatch)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.trace.get("launches"):
        return None
    return ctx.trace["launches"] / ctx.trace["frames"]
