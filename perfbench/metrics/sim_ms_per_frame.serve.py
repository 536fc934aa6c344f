"""Milliseconds of the MPM step per served frame: the harness's span
around the refresh of the layouts and the step, closed by a synchronize
(layer: MPM step)."""


def read(ctx):
    spans = ctx.trace.get("spans") if ctx.kind == "serve" else None
    if not spans:
        return None
    return 1e3 * spans["sim_s"] / spans["frames"]
