"""FT driver: the card's time from the end of the last step call before
the kill (the replica's) to the start of the first after it (the new
computational slice's, on the promoted state): the recovery plan and the
copy of the new replica, in ms."""


def read(ctx):
    win = ctx.win
    spans = getattr(win, "spans", None)
    k = win.kill_step
    if not spans or k < 1:
        return None
    before = [e for t, _, _, e in spans if t == k - 1]
    after = [s for t, role, s, _ in spans if t == k and role == 0]
    if not before or not after:
        return None
    return after[0] - max(before)
