"""Static-analysis support of the port (counterpart of ``repro.analyze``).

Only the reserved-tag registry (``analyze.tags``) is here: the observability
layer labels traffic classes with it.  The schedule verifier, the lint pass
and the divergence detector come with the simulated runtime (ROADMAP.md,
Queue 1 item 9)."""
from repro_torch.analyze.tags import (RESERVED_BANDS, band_owner,
                                      reserved_tags)

__all__ = ["RESERVED_BANDS", "band_owner", "reserved_tags"]
