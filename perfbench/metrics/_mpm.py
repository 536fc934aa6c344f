"""K1-K3's share of their roofline over the traced stretch: each launch
charged the frozen ``p2g`` (K1) or ``g2p`` (K2, K3) bound at the cell's
particles and grid, over the kernels' device time."""


def share(ctx):
    t = sum(ctx.trace["kernel_s"].get(k, 0.0) for k in ("p2g", "g2p", "g2p_derivs"))
    c = ctx.trace.get("counters", {})
    rl = ctx.roofline
    n, g = int(ctx.cfg["scene"]["particles"]), int(ctx.cfg["sim"]["num_grids"])
    bound = (c.get("p2g", 0) * rl.sol_time(*rl.p2g(n, g))
             + (c.get("g2p", 0) + c.get("g2p_derivs", 0)) * rl.sol_time(*rl.g2p(n, g)))
    if t <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / t
