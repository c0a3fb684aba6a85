"""Task programs + canned pool workloads (port of
``repro/pool/workloads.py``).

A *program* is a pure function ``fn(payload, rng, device) -> value``
registered in :data:`PROGRAMS`; ``execute_task`` rebuilds the rng from the
task's own seed, so the value is a bit-identical function of the task dict
no matter which worker (or replica, or reassignment target) runs it.

A program draws its random numbers from that numpy generator, in the
reference's order, and computes in float64 PyTorch on the pool's device.
Its value is plain Python data (``float``/``int``, one ``.item()`` at the
end of the task), never a tensor: the master's result table and the
pool's checkpoints hold what the reference's hold.

Two canned heterogeneous workloads:

  * :func:`hyperparameter_sweep_tasks` — a sweep over (lr, width) of a
    deterministic surrogate of a train-step loss curve (closed-form
    quadratic descent + seeded gradient noise);
  * :func:`monte_carlo_tasks` — a Monte-Carlo estimation ensemble
    (sample-count-heterogeneous pi estimators).

:func:`run_pool` is the one call the demo CLI and the tests make: it
builds the FTSession with the master pinned as the last, unreplicated
rank, runs it, and returns the report plus the pool.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.pool.task import Task, task_seed

PROGRAMS: Dict[str, Callable] = {}


def register_program(name: str):
    def deco(fn):
        PROGRAMS[name] = fn
        return fn
    return deco


def execute_task(td: dict, device):
    """Run one task dict deterministically on ``device``: same dict ->
    same bits."""
    fn = PROGRAMS[td["program"]]
    rng = np.random.default_rng(td["seed"])
    return fn(dict(td["payload"]), rng, torch.device(device))


@register_program("train_surrogate")
def train_surrogate(payload: dict, rng: np.random.Generator,
                    device) -> dict:
    """Surrogate of a (lr, width)-parameterized training run: quadratic
    loss descended for ``steps`` iterations with seeded gradient noise.
    The draws are the reference's (theta, then one 8-vector of noise a
    step, taken here in one call: the same stream); ``lr * grad`` and the
    subtraction stay two operations, so no fused multiply-add can change
    a bit of theta."""
    lr = float(payload.get("lr", 1e-2))
    width = int(payload.get("width", 64))
    steps = int(payload.get("steps", 50))
    theta0 = rng.standard_normal(8)
    noise = rng.standard_normal((steps, 8))
    theta = torch.from_numpy(theta0).to(device) * \
        float(1.0 + 1.0 / np.sqrt(width))
    jitter = 0.05 * torch.from_numpy(noise).to(device)
    for i in range(steps):
        grad = theta + jitter[i]
        theta = theta - lr * grad
    # the reference returns the last step's loss (0.0 after no step)
    loss = (torch.dot(theta, theta) / 2.0).item() if steps else 0.0
    return {"loss": loss, "lr": lr, "width": width}


@register_program("mc_pi")
def mc_pi(payload: dict, rng: np.random.Generator, device) -> dict:
    """Monte-Carlo pi: ``n_samples`` uniform darts."""
    n = int(payload.get("n_samples", 10_000))
    pts = torch.from_numpy(rng.random((n, 2))).to(device)
    hits = int(torch.count_nonzero((pts * pts).sum(dim=1) <= 1.0).item())
    return {"pi": 4.0 * hits / n, "n_samples": n}


def hyperparameter_sweep_tasks(*, lrs=(1e-3, 3e-3, 1e-2, 3e-2),
                               widths=(32, 64, 128),
                               steps: int = 50,
                               pool_seed: int = 0) -> List[Task]:
    """The sweep grid as heterogeneous tasks: cost scales with width."""
    out = []
    i = 0
    for width in widths:
        for lr in lrs:
            out.append(Task(
                task_id=f"hp{i:04d}", program="train_surrogate",
                payload={"lr": lr, "width": width, "steps": steps},
                seed=task_seed(pool_seed, i),
                cost_rounds=1 + width // 64))
            i += 1
    return out


def monte_carlo_tasks(*, n_tasks: int = 12, base_samples: int = 4_000,
                      pool_seed: int = 1) -> List[Task]:
    """A Monte-Carlo ensemble with a heavy-tailed cost mix."""
    out = []
    for i in range(n_tasks):
        scale = 1 + (i % 4)
        out.append(Task(
            task_id=f"mc{i:04d}", program="mc_pi",
            payload={"n_samples": base_samples * scale},
            seed=task_seed(pool_seed, i),
            cost_rounds=scale))
    return out


def run_pool(tasks: List[Task], *, mode: str = "replication",
             n_workers: int = 4, n_steps: int = 60,
             replication_degree: float = 1.0,
             mtbf_s: Optional[float] = None,
             ckpt_interval_s: float = 0.0,
             seed: int = 0, policy="lpt", speculate: bool = False,
             elastic: bool = True, topology: Optional[str] = None,
             step_time_s: float = 1.0, workers_per_node: int = 4,
             injector=None, obs=None, record_schedule: bool = False,
             device=None):
    """Drive a PoolWorkload under FTSession; returns (report, pool).

    The session gets ``n_workers + 1`` logical ranks with
    ``replicable_ranks=n_workers``: the master is the last rank,
    placement-pinned and unreplicated in every mode.  The tasks compute on
    ``device`` (None: the card)."""
    from repro_torch.configs.base import FTConfig
    from repro_torch.ft.injector import WeibullFailureInjector
    from repro_torch.ft.session import FTSession
    from repro_torch.pool.master import PoolWorkload

    kw = {}
    if mtbf_s:
        kw["mtbf_s"] = mtbf_s
    if ckpt_interval_s:
        kw["ckpt_interval_s"] = ckpt_interval_s
    ft = FTConfig(mode=mode, replication_degree=replication_degree,
                  ckpt_backend="memory", topology=topology, **kw)
    if injector is None and mtbf_s:
        injector = WeibullFailureInjector(mtbf_s, seed=seed)
    pool = PoolWorkload(tasks, policy=policy, speculate=speculate,
                        elastic=elastic, record_schedule=record_schedule,
                        device=device)
    session = FTSession(ft=ft, injector=injector,
                        n_logical_workers=n_workers + 1,
                        workers_per_node=workers_per_node,
                        replicable_ranks=n_workers,
                        step_time_s=step_time_s, obs=obs)
    report = session.run(pool, n_steps)
    return report, pool
