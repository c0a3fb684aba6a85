"""Device: the share of the profiled sub-window in which no operation ran
on the card (the complement of the union of its device intervals), in %."""


def read(ctx):
    prof = getattr(ctx.win, "profile", None)
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
