"""Failure injection (port of the parts of ``repro/ft/injector.py`` the
serving path uses). Every injector is driven the same way:

    injector.prepare(horizon_s, workers)       # once, at run start
    events = injector.poll(step_idx, now_s)    # each step; drained events

``poll`` returns each ``FailureEvent`` exactly once per run; ``prepare``
resets the drain state so one injector can serve repeated runs. The
time-indexed, Weibull and log-replay injectors wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union


@dataclass
class FailureEvent:
    """Workers killed at one instant (copy of
    ``repro.core.failure_sim.FailureEvent``)."""

    time_s: float
    workers: Tuple[int, ...]


class FailureInjector:
    """Base: injects nothing."""

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        """Called once before the run; horizon_s bounds virtual time."""

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        return []


class NoFailures(FailureInjector):
    pass


class StepKillInjector(FailureInjector):
    """Step-indexed kills: {step_idx: [worker ids]} — the serve driver's
    ``kill_at``."""

    def __init__(self, kill_schedule: Dict[int, Sequence[int]]):
        self._original = {int(s): list(ws)
                          for s, ws in (kill_schedule or {}).items()}
        self.schedule = dict(self._original)

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        self.schedule = dict(self._original)

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        ws = self.schedule.pop(step_idx, None)
        if not ws:
            return []
        return [FailureEvent(time_s=now_s, workers=tuple(ws))]


InjectorSpec = Union[FailureInjector, Dict[int, Sequence[int]], None]


def as_injector(spec: InjectorSpec) -> FailureInjector:
    """None -> NoFailures, dict -> StepKillInjector, FailureInjector ->
    itself."""
    if spec is None:
        return NoFailures()
    if isinstance(spec, FailureInjector):
        return spec
    if isinstance(spec, dict):
        return StepKillInjector(spec)
    raise TypeError(f"cannot build a FailureInjector from {spec!r}")
