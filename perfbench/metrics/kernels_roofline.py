"""Kernels: Σ least time over Σ device time of the port's hand-written
kernels (K1, K2, K3, forward and backward) in the profiled sub-window,
in %."""
from perfbench.metrics._roofline import share


def read(ctx):
    return share(ctx, ("K1", "K1_bwd", "K2", "K2_bwd", "K3", "K3_bwd"))
