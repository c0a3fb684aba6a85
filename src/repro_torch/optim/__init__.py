"""Optimizers of the port (counterpart of ``repro.optim``)."""
from repro_torch.optim import adamw

__all__ = ["adamw"]
