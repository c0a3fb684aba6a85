"""Worker-side pool protocol: the reserve -> execute -> report loop (port
of ``repro/pool/worker.py``).

One worker round (per endpoint, per scheduler step):

  1. if a directive is owed (the previous status was ``ready`` or
     ``result``), consume it: ``("task", td)`` loads the task and its
     ``cost_rounds`` budget, ``("idle",)`` leaves the worker free;
  2. if a task is loaded, burn one cost round; on the last round execute
     the program deterministically (``pool.workloads``) from the task's
     own seed, on the pool's device;
  3. report status to the master — ``("result", id, value)``,
     ``("busy", id)`` or ``("ready",)`` — logged (``log=True``) so a
     promoted master view can replay it.

The round is a pure function of (worker state, inbox, t): a rank's
computational and replica endpoints receive identical directives (the
transport's intercomm fill-in), run identical rounds, and advance
bit-identical worker states — which is exactly what makes mid-task
promotion exact.  Replica-side status sends are skipped by the
transport (the master is unreplicated) with counters still advancing,
so a promoted worker's send-ID streams line up with what the master
already consumed.

The initial task *program* reaches the workers before round zero via a
``ReferenceCollectives`` broadcast from the master rank (the armi-style
"ship the interface, then stream the work" idiom) — see
``PoolWorkload._broadcast_program``.
"""
from __future__ import annotations

from repro_torch.pool import master as _master
from repro_torch.pool.workloads import execute_task


def fresh_worker_state(program_spec=None) -> dict:
    """A just-(re)spawned worker: free, owing no directive."""
    return {"task": None, "remaining": 0, "awaiting": False,
            "executed": 0, "program": program_spec}


def run_worker_round(pool, ep, ws, t: int) -> None:
    """Advance one worker endpoint by one scheduler round."""
    tp = pool.transport
    mrank = pool.master_rank
    if ws["awaiting"]:
        m = tp.match_recv(ep, mrank, _master.TAG_POOL_TASK)
        if m is None:
            raise RuntimeError(
                f"pool worker {ep.wid}: directive missing at round {t} "
                f"(protocol error: master owes one per non-busy status)")
        pool._record(ep, ("recv", mrank, _master.TAG_POOL_TASK))
        directive = m.payload
        if directive[0] == "task":
            td = dict(directive[1])
            ws["task"] = td
            ws["remaining"] = max(1, int(td["cost_rounds"]))
        ws["awaiting"] = False
    if ws["task"] is not None:
        ws["remaining"] -= 1
        if ws["remaining"] <= 0:
            td = ws["task"]
            value = execute_task(td, pool.device)
            ws["task"] = None
            ws["executed"] += 1
            status = ("result", td["task_id"], value)
        else:
            status = ("busy", ws["task"]["task_id"])
    else:
        status = ("ready",)
    pool._record(ep, ("send", mrank, _master.TAG_POOL_STATUS))
    tp.send(ep, mrank, _master.TAG_POOL_STATUS, status, t, log=True)
    # a busy worker owes no directive; any other status earns one
    ws["awaiting"] = status[0] != "busy"
