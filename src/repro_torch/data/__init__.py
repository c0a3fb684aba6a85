"""The deterministic, seekable token stream (port of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, ShardedSource, TokenSource

__all__ = ["DataConfig", "TokenSource", "ShardedSource"]
