"""Share of the traced served frames in which the card ran nothing (layer: device)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
