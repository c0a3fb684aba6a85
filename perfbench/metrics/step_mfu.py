"""Model step: the train step's model FLOPs (``work/<family>.py``'s own
count from the configuration's shapes) times the steps both slices ran
in the traced run's window, over the window's time x the H100's 989
TFLOP/s dense bf16, in %. The profiled steps and the profiler's start and
stop are left out of both: the profiler's host overhead slows the steps
it records."""

PEAK = 989e12


def read(ctx):
    win = ctx.win
    spans = getattr(win, "spans", None)
    if not spans:
        return None
    lo, hi = win.profiled
    starts = [s for t, role, s, _ in spans if t == lo and role == 0]
    ends = [e for t, role, _, e in spans if t == hi and role == 1]
    profiled_ms = max(ends) - min(starts)
    steps = win.steps - (hi - lo + 1)
    ms = 1e3 * win.window_s - win.paused_ms - profiled_ms
    flops = ctx.work.step_flops(ctx.model, ctx.traffic) * 2 * steps
    return 100.0 * flops / (1e-3 * ms * PEAK)
