"""The elastic replica-aware master/worker task pool (port of
``repro/pool/``).

A master rank dispatches heterogeneous tasks to worker ranks over the
replica-aware transport (reserved tag band ``repro_torch.pool.master`` in
``analyze.tags``); worker deaths are absorbed forward — replica promotion
finishes the in-flight task bit-identically, or the rank is retired and
its task reassigned — never a world rollback.  Runs as a first-class
Workload under ``FTSession.run`` in all four FT modes; the tasks compute
in float64 on the pool's device.
"""
from repro_torch.pool.master import (TAG_POOL_STATUS, TAG_POOL_TASK,
                                     PoolWorkload)
from repro_torch.pool.scheduling import (POLICIES, FifoPolicy, LptPolicy,
                                         SchedulingPolicy, make_policy)
from repro_torch.pool.task import Task, TaskResult, make_tasks, task_seed
from repro_torch.pool.workloads import (PROGRAMS, execute_task,
                                        hyperparameter_sweep_tasks,
                                        monte_carlo_tasks, register_program,
                                        run_pool)

__all__ = [
    "TAG_POOL_STATUS", "TAG_POOL_TASK", "PoolWorkload",
    "POLICIES", "FifoPolicy", "LptPolicy", "SchedulingPolicy",
    "make_policy",
    "Task", "TaskResult", "make_tasks", "task_seed",
    "PROGRAMS", "execute_task", "hyperparameter_sweep_tasks",
    "monte_carlo_tasks", "register_program", "run_pool",
]
