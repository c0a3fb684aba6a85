"""Tokens of the steps the computational slice completed in the window,
over the window's time on the card (CUDA events from the first step's
start to the end of the last). The replica's duplicate tokens are not
counted; the promotion, the replica's steps and the FT driver's work lie
inside the window."""


def read(ctx):
    return ctx.win.tokens / ctx.win.window_s
