"""Cost-model injection (port of ``repro/clock/pricing.py``, unpriced only).

The JAX package prices messages over a topology graph when
``FTConfig.topology`` is set. The port has no copy of that graph and
transport yet (ROADMAP.md), so it builds the unpriced fabric and refuses a
topology instead of ignoring it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ClockPricing:
    """The priced-fabric triple; all ``None`` when unpriced."""

    graph: object = None
    cost_model: object = None
    engine_ops: Optional[dict] = None

    @property
    def priced(self) -> bool:
        return self.cost_model is not None


def pricing_from_ft(ft, cluster) -> ClockPricing:
    """The unpriced ``ClockPricing``; raises when ``ft.topology`` is set."""
    del cluster
    if getattr(ft, "topology", None):
        raise NotImplementedError(
            f"topology pricing ({ft.topology!r}) is not ported to PyTorch "
            f"yet (ROADMAP.md, Queue 1 item 3)")
    return ClockPricing()
