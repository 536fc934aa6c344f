"""K4/K5's share of their roofline over the traced stretch: each launch
charged the frozen ``composite`` bound at the pair counts that the
benchmark's reference draws for the traced frames (their mean over the
renders), over the kernels' device time."""


def share(ctx):
    t = ctx.trace["kernel_s"].get("composite", 0.0) + ctx.trace["kernel_s"].get("composite_bwd", 0.0)
    c = ctx.trace.get("counters", {})
    launches = c.get("composite", 0) + c.get("composite_bwd", 0)
    pairs = [p for frame in ctx.pairs for p in frame]
    if t <= 0.0 or not launches or not pairs:
        return None
    rl = ctx.roofline
    view = ctx.cfg["views"][0]
    per = sum(rl.sol_time(*rl.composite(p, view["width"], view["height"])) for p in pairs) / len(pairs)
    return 100.0 * launches * per / t
