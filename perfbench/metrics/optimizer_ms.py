"""Optimizer: the card's time per ``adamw.update`` call in the window,
from CUDA events in a wrapper of that module attribute, in ms (the mean
over the calls of both slices)."""


def read(ctx):
    times = getattr(ctx.win, "optimizer_ms", None)
    if not times:
        return None
    return sum(times) / len(times)
