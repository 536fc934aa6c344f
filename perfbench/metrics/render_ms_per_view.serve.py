"""Milliseconds per rendered view: the harness's span around the binding
and every view's render and copy, closed by a synchronize, over the
views (layer: rasterizer)."""


def read(ctx):
    spans = ctx.trace.get("spans") if ctx.kind == "serve" else None
    if not spans:
        return None
    return 1e3 * spans["render_s"] / (spans["frames"] * spans["views"])
