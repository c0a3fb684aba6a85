"""repro_torch.clock — the virtual-time ledger FTSession charges (port of
``repro.clock``: ``TimeBreakdown``, ``VirtualClock``, unpriced
``pricing_from_ft``)."""
from repro_torch.clock.breakdown import COMPONENTS, TimeBreakdown
from repro_torch.clock.clock import VirtualClock, injection_horizon
from repro_torch.clock.pricing import ClockPricing, pricing_from_ft

__all__ = [
    "TimeBreakdown", "COMPONENTS",
    "VirtualClock", "injection_horizon",
    "ClockPricing", "pricing_from_ft",
]
