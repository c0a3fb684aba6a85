"""VirtualClock: schedule clock + priced ledger (port of
``repro/clock/clock.py``).

  * ``now`` is the schedule clock — the value failure injectors and the
    coordinator checkpoint timer read;
  * ``breakdown`` is the ``TimeBreakdown`` ledger every layer charges into;
  * ``charge(component, seconds)`` books time into the ledger and, by
    default, advances the schedule clock with it; ``advance=False`` books
    a ledger-only charge (FTSession's repair and replica share);
  * ``charge_comm(transport)`` drains a priced ``ReplicaTransport``: the
    max per-sender α‑β message time accrued since the last take is charged
    to ``comm``;
  * ``injection_horizon`` is the failure-injection horizon with slack;
  * ``obs`` (``obs.ObsRecorder.bind_clock``) mirrors every charge, with
    its ``label``, to ``obs.on_charge``; None (the default) costs one
    check per charge.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.clock.breakdown import COMPONENTS, TimeBreakdown


def injection_horizon(n_steps: int, step_time_s: float,
                      ckpt_cost_s: float = 0.0) -> float:
    """Failure-injection horizon with slack: rollbacks extend virtual time
    past ``n_steps``, so time-indexed schedules get 2x headroom, plus a
    checkpoint-write allowance."""
    return n_steps * step_time_s * 2.0 + 100.0 * ckpt_cost_s


class VirtualClock:
    """Schedule clock + TimeBreakdown ledger. ``cost_model`` is the
    optional ``topo.TopoCostModel`` the owning runtime priced its
    transports with, kept so other layers can price through the same
    model."""

    def __init__(self, breakdown: Optional[TimeBreakdown] = None,
                 cost_model=None):
        self.breakdown = breakdown if breakdown is not None \
            else TimeBreakdown()
        self.cost_model = cost_model
        self.now = 0.0
        # optional observability hook (obs.ObsRecorder.bind_clock): every
        # charge is mirrored to obs.on_charge(component, seconds, label).
        # None (default) keeps charge() allocation-free.
        self.obs = None

    def charge(self, component: str, seconds: float, *,
               advance: bool = True,
               label: Optional[str] = None) -> float:
        """Book ``seconds`` of ``component`` time into the ledger;
        ``advance`` also moves the schedule clock. ``label`` names what the
        charge was for (e.g. which recovery arc a ``repair`` charge belongs
        to); the ledger ignores it, only the mirrored ``obs.on_charge``
        call carries it. Returns ``seconds``."""
        if component not in COMPONENTS:
            raise ValueError(f"unknown time component {component!r}; "
                             f"expected one of {COMPONENTS}")
        if seconds < 0:
            raise ValueError(f"cannot charge negative time ({seconds})")
        setattr(self.breakdown, component,
                getattr(self.breakdown, component) + seconds)
        if advance:
            self.now += seconds
        if self.obs is not None:
            self.obs.on_charge(component, seconds, label)
        return seconds

    # -- priced-transport draining -------------------------------------------

    def charge_comm(self, transport, *, component: str = "comm",
                    advance: bool = True) -> float:
        """Drain the transport's accrued α‑β message time and charge it
        (to ``comm`` by default)."""
        dt = transport.take_comm_time()
        if dt:
            self.charge(component, dt, advance=advance)
        return dt
