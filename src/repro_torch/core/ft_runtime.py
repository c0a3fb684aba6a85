"""FTTrainer: the legacy training surface over ``ft`` (port of
``repro/core/ft_runtime.py``).

    trainer = FTTrainer(train_step=..., init_state=..., batch_fn=...,
                        ft=FTConfig(mode="combined"), ckpt_dir=...,
                        kill_schedule={5: [0]})
    report = trainer.run(n_steps)       # -> RunReport (== TrainReport)

New code builds an ``FTSession`` and a ``TrainWorkload`` directly
(``launch.train.build_session``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import FTConfig
from repro_torch.ft.session import FTSession, RunReport, StepEvent, TrainReport
from repro_torch.ft.workload import TrainWorkload, copy_tree

# the reference's old import site (``from repro.core.ft_runtime import
# _copy_tree``) names the cloning copy here (F1: a copy that aliased the
# tensors would let the in-place update reach the replica)
_copy_tree = copy_tree

__all__ = ["FTTrainer", "TrainReport", "RunReport", "StepEvent",
           "_copy_tree"]


class FTTrainer:
    """Thin adapter: (train_step, init_state, batch_fn) -> TrainWorkload,
    (ft, kill_schedule, ...) -> FTSession. ``simulate_replica`` executes
    the replica slice on the same device (False: no replica is kept)."""

    def __init__(self, *, train_step: Callable, init_state: Callable,
                 batch_fn: Callable[[int], dict], ft: FTConfig,
                 ckpt_dir: Optional[str] = None,
                 n_logical_workers: int = 8,
                 workers_per_node: int = 4,
                 simulate_replica: bool = True,
                 kill_schedule: Optional[Dict[int, List[int]]] = None,
                 step_time_s: float = 1.0):
        self.workload = TrainWorkload(train_step=train_step,
                                      init_state=init_state,
                                      batch_fn=batch_fn)
        self.session = FTSession(ft=ft, ckpt_dir=ckpt_dir,
                                 injector=dict(kill_schedule or {}),
                                 n_logical_workers=n_logical_workers,
                                 workers_per_node=workers_per_node,
                                 simulate_replica=simulate_replica,
                                 step_time_s=step_time_s)
        self.ft = ft
        # legacy attribute surface
        self.train_step = train_step
        self.init_state = init_state
        self.batch_fn = batch_fn

    @property
    def simulate_replica(self) -> bool:
        return self.session.simulate_replica

    @simulate_replica.setter
    def simulate_replica(self, value: bool):
        self.session.simulate_replica = value

    @property
    def rmap(self):
        return self.session.rmap

    @property
    def coords(self):
        return self.session.coords

    def run(self, n_steps: int) -> RunReport:
        return self.session.run(self.workload, n_steps)
