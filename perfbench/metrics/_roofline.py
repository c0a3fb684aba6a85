"""The share of the least time in the device time of the port's kernel
launches in the profiled sub-window. The least time of each launch comes
from ``work/cost.py`` at the shape ``work/<family>.py`` derives from the
configuration and traffic; the device time is that of the profiler's
kernels whose names carry one of the entry names of ``work/kernels.json``
for those kernels."""
import re

from perfbench.work import cost


def _matches(names):
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names))
                     + r")(?![A-Za-z0-9_])")
    return pat.search


def seen(ctx, kernels) -> int:
    """Launches of ``kernels`` in the profiled sub-window."""
    prof = getattr(ctx.win, "profile", None)
    names = [n for k in kernels for n in ctx.kernel_names.get(k, [])]
    if prof is None or not names:
        return 0
    hit = _matches(names)
    return sum(c for name, c in prof.counts.items() if hit(name))


def expected(ctx, kernels) -> int:
    """Calls of ``kernels`` that the configuration implies for the
    sub-window's slice steps."""
    prof = ctx.win.profile
    return sum(count * 2 * prof.steps for kern, _, _, count in
               ctx.work.launches(ctx.model, ctx.traffic) if kern in kernels)


def share(ctx, kernels):
    """Σ least time / Σ device time in %, over ``kernels`` (keys of
    ``work/kernels.json``); None where none is launched or seen."""
    prof = getattr(ctx.win, "profile", None)
    if prof is None:
        return None
    least = 0.0
    for kern, fn, args, count in ctx.work.launches(ctx.model, ctx.traffic):
        if kern in kernels:
            ms = cost.bound(getattr(cost, fn)(*args))["bound_ms"]
            least += ms * count * 2 * prof.steps / 1e3
    names = [n for k in kernels for n in ctx.kernel_names.get(k, [])]
    hit = _matches(names) if names else None
    device = sum(s for name, s in prof.kernels.items() if hit and hit(name))
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
