"""Host seconds from the process's start to the first measured step:
imports, the kernels' build or load, the weights, the optimizer state,
the warm-up steps and the replica's copy."""


def read(ctx):
    return ctx.win.setup_s
