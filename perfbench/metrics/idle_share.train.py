"""Share of the traced training epoch in which the card ran nothing (layer: device)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
