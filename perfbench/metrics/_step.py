"""The whole frame's share of the card's peak: the frozen
``grounding_step_frame`` bound (``bwd_factor`` 3 for training, 1 for
serving) over the window's time per frame."""


def share(ctx, bwd_factor: float, substeps: int):
    pairs = [p for frame in ctx.pairs for p in frame]
    if not pairs or ctx.frame_s <= 0.0:
        return None
    cfg, view = ctx.cfg, ctx.cfg["views"][0]
    bound = ctx.roofline.grounding_step_frame(
        int(cfg["scene"]["particles"]), int(cfg["sim"]["num_grids"]), view["width"], view["height"],
        int(sum(pairs) / len(pairs)), int(cfg["raster"]["max_pairs"]), substeps=substeps,
        n_views=len(cfg["views"]), bwd_factor=bwd_factor)
    return 100.0 * bound / ctx.frame_s
