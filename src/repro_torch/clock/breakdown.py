"""TimeBreakdown: the priced virtual-time ledger (the paper's Fig 9).

A copy of ``repro/clock/breakdown.py`` for the PyTorch port: ``FTSession``
charges its step loop, replica share and repair into it.
"""
from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass
class TimeBreakdown:
    """Virtual-time components (the paper's Fig 9).  ``comm`` is the
    α‑β-priced message time (repro.topo) — zero unless FTConfig.topology
    is set, since the flat cost model folds communication into
    step_time_s."""

    useful: float = 0.0
    redundant: float = 0.0          # replica share of compute
    comm: float = 0.0               # topo-priced per-message time
    ckpt_write: float = 0.0
    restore: float = 0.0
    rollback: float = 0.0           # lost work re-executed after restart
    repair: float = 0.0             # shrink + message recovery
    log_removal: float = 0.0

    @property
    def total(self) -> float:
        return (self.useful + self.redundant + self.comm + self.ckpt_write
                + self.restore + self.rollback + self.repair
                + self.log_removal)

    def as_dict(self) -> dict:
        return {"useful": self.useful, "redundant": self.redundant,
                "comm": self.comm,
                "ckpt_write": self.ckpt_write, "restore": self.restore,
                "rollback": self.rollback, "repair": self.repair,
                "log_removal": self.log_removal, "total": self.total}

    def summary(self) -> str:
        """Nonzero components + total as one benchmark-table cell."""
        parts = [f"{k}={v:.3g}s" for k, v in self.as_dict().items()
                 if k != "total" and v > 0]
        return " ".join(parts + [f"total={self.total:.3g}s"])


# component names a VirtualClock.charge() accepts
COMPONENTS = tuple(f.name for f in fields(TimeBreakdown))
