"""Unified failure injection (port of ``repro/ft/injector.py``).

One interface subsumes the three mechanisms:
  * step-indexed kill schedules ({step: [workers]} dicts; the serve
    driver's ``kill_at``),
  * Weibull(0.7) process-failure schedules (``core.failure_sim``, paper §7),
  * Tsubame-style node-failure log replay (paper Fig 13).

Consumers (FTSession, SimRuntime, the figure benchmarks) drive every
injector the same way:

    injector.prepare(horizon_s, workers)       # once, at run start
    events = injector.poll(step_idx, now_s)    # each step; drained events

``poll`` returns the ``FailureEvent``s that fire at this step (step-indexed
injectors) or at/before this virtual time (time-indexed injectors); each
event is returned exactly once per run.  ``prepare`` resets the drain state
(and redraws stochastic schedules), so one injector can serve repeated
``FTSession.run`` calls.  ``FailureEvent`` lives in ``core.failure_sim``
and is re-exported here.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.failure_sim import (FailureEvent,
                                          LogReplayInjector, WeibullInjector)


class FailureInjector:
    """Base: injects nothing. Subclasses override ``poll`` (and ``prepare``
    when the schedule depends on the horizon or the worker set)."""

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        """Called once before the run; horizon_s bounds virtual time."""

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        return []


class NoFailures(FailureInjector):
    pass


class StepKillInjector(FailureInjector):
    """Step-indexed kills: {step_idx: [worker ids]} — the trainer's
    ``kill_schedule`` and the serve driver's ``kill_at``, unified."""

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


class TimedEventInjector(FailureInjector):
    """Wraps a pre-computed ``FailureEvent`` list; drains by virtual time."""

    def __init__(self, events: Iterable[FailureEvent]):
        self.events = sorted(events or [], key=lambda e: e.time_s)
        self._i = 0

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        self._i = 0

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        out = []
        while self._i < len(self.events) and \
                self.events[self._i].time_s <= now_s:
            out.append(self.events[self._i])
            self._i += 1
        return out


class WeibullFailureInjector(FailureInjector):
    """Weibull(shape) process-level failures (paper §7); the schedule is
    drawn at ``prepare`` time against the run horizon and worker set."""

    def __init__(self, mtbf_s: float, shape: float = 0.7, seed: int = 0):
        self.inner = WeibullInjector(mtbf_s, shape=shape, seed=seed)
        self._timed: Optional[TimedEventInjector] = None

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        self._timed = TimedEventInjector(
            self.inner.schedule(horizon_s, list(workers)))

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        return self._timed.poll(step_idx, now_s) if self._timed else []


class LogReplayFailureInjector(FailureInjector):
    """Node-failure log replay (paper Fig 13), time-scaled."""

    def __init__(self, log: Sequence[Tuple[float, str]],
                 workers_per_node: int, n_workers: int,
                 time_scale: float = 1.0):
        self.inner = LogReplayInjector(log, workers_per_node, n_workers,
                                       time_scale=time_scale)
        self._timed: Optional[TimedEventInjector] = None

    def prepare(self, horizon_s: float, workers: Sequence[int]) -> None:
        self._timed = TimedEventInjector(
            self.inner.schedule(horizon_s, list(workers)))

    def poll(self, step_idx: int, now_s: float) -> List[FailureEvent]:
        return self._timed.poll(step_idx, now_s) if self._timed else []


InjectorSpec = Union[FailureInjector, Dict[int, Sequence[int]],
                     Iterable[FailureEvent], None]


def as_injector(spec: InjectorSpec) -> FailureInjector:
    """Coerce the injection specs into one FailureInjector:
    None -> NoFailures, dict -> StepKillInjector, FailureEvent list ->
    TimedEventInjector, FailureInjector -> itself."""
    if spec is None:
        return NoFailures()
    if isinstance(spec, FailureInjector):
        return spec
    if isinstance(spec, dict):
        return StepKillInjector(spec)
    events = list(spec)
    if events and not all(isinstance(e, FailureEvent) for e in events):
        raise TypeError(f"cannot build a FailureInjector from {spec!r}")
    return TimedEventInjector(events)
