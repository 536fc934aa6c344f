"""Readers of the traced stretch's charges to the port's spans
(``perfbench/spantrace.py``): a metric's milliseconds are the idle and
busy time charged to the paths whose innermost owned span it owns."""
from perfbench import spantrace


def ms(ctx, kind: str, key: str, units: float):
    """Milliseconds charged to ``key`` over ``units`` (frames, views or
    epochs) in cells of ``kind``, or None."""
    if ctx.kind != kind:
        return None
    s = spantrace.owned_s(ctx.trace, key)
    return None if s is None else 1e3 * s / units


def syncs_per_frame(ctx, kind: str):
    """Blocking runtime calls on the program's paths per traced frame."""
    if ctx.kind != kind:
        return None
    n = spantrace.host_syncs(ctx.trace)
    return None if n is None else n / ctx.trace["frames"]


def untraced_share(ctx, kind: str):
    """Share of the traced wall charged to no span."""
    by_path = ctx.trace.get("by_path") if ctx.kind == kind else None
    if not by_path or not ctx.trace.get("window_s"):
        return None
    idle, busy, _ = by_path.get(spantrace.UNTRACED, (0.0, 0.0, 0))
    return 100.0 * (idle + busy) / ctx.trace["window_s"]


def rebuild_share(ctx, kind: str):
    """Share of the layouts' refreshes that rebuilt the block sort."""
    c = ctx.trace.get("counters", {}) if ctx.kind == kind else {}
    if not c.get("layouts.refreshed"):
        return None
    return 100.0 * c.get("layouts.rebuilt", 0) / c["layouts.refreshed"]
