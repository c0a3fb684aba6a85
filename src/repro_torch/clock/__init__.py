"""repro_torch.clock — the priced virtual-time ledger (port of
``repro.clock``: ``TimeBreakdown``, ``VirtualClock`` with ``charge_comm``,
and ``pricing_from_ft``, which builds the topology cost model and the
selecting collective registry from ``FTConfig.topology``). FTSession
charges its steps, repair and replica share; the serving fan-out charges
its priced traffic to ``comm``."""
from repro_torch.clock.breakdown import COMPONENTS, TimeBreakdown
from repro_torch.clock.clock import VirtualClock, injection_horizon
from repro_torch.clock.pricing import ClockPricing, pricing_from_ft

__all__ = [
    "TimeBreakdown", "COMPONENTS",
    "VirtualClock", "injection_horizon",
    "ClockPricing", "pricing_from_ft",
]
