"""Wall milliseconds per trained frame: the window's whole epochs over the
frames they trained, read from the host's clock (layer: trainer). The
host's speed drifts from minute to minute, so it is reported per layer."""


def read(ctx):
    if ctx.kind != "train" or ctx.frame_s <= 0.0:
        return None
    return 1e3 * ctx.frame_s
