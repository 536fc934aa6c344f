"""Blocking runtime calls inside the port's spans per trained frame of the
traced epoch (layer: host dispatch)."""
from perfbench.metrics._spans import syncs_per_frame


def read(ctx):
    return syncs_per_frame(ctx, "train")
