"""Fault-tolerance API of the port (counterpart of ``repro.ft``):
``TrainWorkload``, ``DecodeWorkload``, ``SimAppWorkload``, the four
strategies (``NoFT``, ``CheckpointStrategy``, ``ReplicationStrategy``,
``CombinedStrategy``), the injectors (step kills, timed events, Weibull,
log replay) and ``FTSession``."""
from repro_torch.ft.injector import (FailureEvent, FailureInjector,
                                     LogReplayFailureInjector, NoFailures,
                                     StepKillInjector, TimedEventInjector,
                                     WeibullFailureInjector, as_injector)
from repro_torch.ft.session import (FTSession, RunReport, StepEvent,
                                    TrainReport)
from repro_torch.ft.strategy import (CheckpointStrategy, CombinedStrategy,
                                     FTStrategy, NoFT, ReplicationStrategy,
                                     make_strategy)
from repro_torch.ft.workload import (DecodeWorkload, SimAppWorkload,
                                     TrainWorkload, Workload, copy_tree)

__all__ = [
    "Workload", "TrainWorkload", "DecodeWorkload", "SimAppWorkload",
    "copy_tree",
    "FTStrategy", "NoFT", "CheckpointStrategy", "ReplicationStrategy",
    "CombinedStrategy", "make_strategy",
    "FailureEvent", "FailureInjector", "NoFailures", "StepKillInjector",
    "TimedEventInjector", "WeibullFailureInjector",
    "LogReplayFailureInjector", "as_injector",
    "FTSession", "RunReport", "StepEvent", "TrainReport",
]
