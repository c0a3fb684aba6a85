"""The allocator's peak over the window (``max_memory_allocated`` after a
reset at its start), in 1e9 bytes: two train states, and three while a
promotion copies the new replica."""


def read(ctx):
    peak = ctx.win.peak_bytes
    return None if peak is None else peak / 1e9
