"""Kernel launches the card ran per trained frame in the traced epoch (layer: host dispatch)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.get("launches"):
        return None
    return ctx.trace["launches"] / ctx.trace["frames"]
