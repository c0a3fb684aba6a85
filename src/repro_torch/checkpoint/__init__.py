"""On-disk checkpoints in the reference's format (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.io import Checkpointer

__all__ = ["Checkpointer"]
