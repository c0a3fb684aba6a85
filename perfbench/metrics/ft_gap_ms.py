"""FT driver: the card's time in the window outside the computational and
the replica slices' step calls, per session step (the promotion's step
included), in ms. Each call is bracketed by CUDA events; the profiler's
start and stop in the traced run are not counted."""


def read(ctx):
    win = ctx.win
    spans = getattr(win, "spans", None)
    if not spans:
        return None
    inside = sum(e - s for _, _, s, e in spans)
    return (1e3 * win.window_s - win.paused_ms - inside) / win.steps
