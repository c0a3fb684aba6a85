"""Workload protocol and its adapters (port of ``repro/ft/workload.py``:
``TrainWorkload``, ``DecodeWorkload`` and ``SimAppWorkload``).

A workload is anything that can be driven step by step over an explicit
state tree:

    init_state() -> state
    step(state, t) -> (state, metrics)        # t is the step index

Determinism contract: ``step`` is a function of (state, t) only — the same
state and step index always give bit-identical results — which is what
makes replica double execution equal to running on a second slice and
promotion exact (the paper's FT theorem).
"""
from __future__ import annotations

import copy
from collections import deque
from typing import (Any, Callable, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.tree import copy_tree

__all__ = ["Workload", "TrainWorkload", "DecodeWorkload", "SimAppWorkload",
           "copy_tree"]


@runtime_checkable
class Workload(Protocol):
    def init_state(self) -> Any: ...

    def step(self, state: Any, t: int) -> Tuple[Any, Any]: ...


class TrainWorkload:
    """The train step as a Workload. ``batch_fn(t)`` must be a pure
    function of the step index (the deterministic data cursor).

    ``train_step(state, batch) -> (state, loss)`` may write the state it
    is given in place (the port's AdamW does): the replica's state is a
    ``copy_tree`` clone and every checkpoint a copy, so nothing else holds
    those tensors. The state is {"params", "opt"}, written to disk by
    ``checkpoint.Checkpointer`` in the reference's format."""

    disk_checkpointable = True

    def __init__(self, *, train_step: Callable, init_state: Callable,
                 batch_fn: Callable[[int], dict]):
        self.train_step = train_step
        self.init_state_fn = init_state
        self.batch_fn = batch_fn

    def init_state(self):
        return self.init_state_fn()

    def step(self, state, t):
        state, loss = self.train_step(state, self.batch_fn(t))
        return state, loss


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


class DecodeWorkload:
    """Greedy decode as a Workload: state carries the KV cache, the last
    token, the position cursor and the emitted tokens (host numpy arrays).
    One step = append the current token and decode the next one.
    Replicating this state IS the paper's replication story for serving:
    the replica's cache stays current, so failover is one promotion with no
    prefill replay.

    ``step`` writes the KV cache of the state it is given in place (the
    decode step's ring write); everything else in the returned state is
    new. The replica's state is a clone (``copy_tree``), so the two slices
    never share a cache buffer.  The checkpoint strategies keep its state
    in the replicated in-memory store: ``out`` grows every step, so it is
    no disk checkpoint."""

    disk_checkpointable = False

    def __init__(self, *, params, prefill: Callable, decode: Callable,
                 batch: dict, prompt_len: int):
        self.params = params
        self.prefill = prefill
        self.decode = decode
        self.batch = batch
        self.prompt_len = prompt_len

    def init_state(self):
        logits, cache = self.prefill(self.params, self.batch)
        tok = _greedy(logits)
        pos = torch.full((tok.shape[0], 1), self.prompt_len,
                         dtype=torch.int32, device=tok.device)
        return {"cache": cache, "tok": tok, "pos": pos, "out": []}

    def step(self, state, t):
        out = state["out"] + [state["tok"].cpu().numpy()]
        logits, cache = self.decode(self.params, state["cache"],
                                    state["tok"], state["pos"])
        return {"cache": cache, "tok": _greedy(logits),
                "pos": state["pos"] + 1, "out": out}, None

    @staticmethod
    def tokens(state) -> np.ndarray:
        return np.concatenate(state["out"], axis=1)


class SimAppWorkload:
    """Run a simrt-style generator app (``step(rank, state, t)`` yielding
    communication ops) as a single sequential Workload.

    The composite state is {rank: rank_state}; ops are resolved in-process
    by a deterministic round-robin scheduler.  Fault tolerance happens at
    whole-application granularity in FTSession (the replica is a deep copy
    of all rank states), complementing simrt's message-level pipeline.

    The resolver here is intentionally the *failure-free* subset of the op
    protocol (no roles, no message logging, no mid-step kills) — simrt's
    SimRuntime remains the authoritative implementation of the full
    replicated protocol.  Collectives (allreduce/barrier/bcast/gather/
    reduce_scatter/alltoall) share their semantics with the replicated
    CollectiveEngine through ``comm.ReferenceCollectives``, so the two
    resolvers cannot drift.  A delivered payload is a deep copy (a tensor's
    clone on its device).
    """

    disk_checkpointable = False

    def __init__(self, app):
        self.app = app
        self.n = app.n_ranks

    def init_state(self):
        return {r: self.app.init_state(r) for r in range(self.n)}

    def check(self, states) -> Optional[float]:
        chk = getattr(self.app, "check", None)
        return chk(states) if chk else None

    # -- sequential op resolver ---------------------------------------------

    def step(self, states, t):
        from repro_torch.comm import NOTHING, ReferenceCollectives

        gens = {r: self.app.step(r, states[r], t) for r in range(self.n)}
        inbox: Dict[int, deque] = {r: deque() for r in range(self.n)}
        pending: Dict[int, Optional[tuple]] = {r: None for r in range(self.n)}
        done: Dict[int, Any] = {}
        coll = ReferenceCollectives(self.n)

        def deliver(dst, src, tag, payload):
            inbox[dst].append((src, tag, copy.deepcopy(payload)))

        def take(rank, src, tag):
            box = inbox[rank]
            for i, (s, tg, p) in enumerate(box):
                if (src is None or s == src) and tg == tag:
                    del box[i]
                    return (s, p)
            return None

        def intake(rank, op):
            """Returns a pending descriptor, or None when non-blocking."""
            kind = op[0]
            if kind == "send":
                _, dst, tag, payload = op
                deliver(dst, rank, tag, payload)
                return None
            if kind == "exchange":
                _, outmap, tag = op
                for dst, payload in sorted(outmap.items()):
                    deliver(dst, rank, tag, payload)
                return ("exchange_wait", sorted(outmap.keys()), tag, {})
            if kind == "recv":
                return ("recv", op[1], op[2])
            if kind == "recv_any":
                return ("recv_any", op[1])
            return coll.post(rank, op)       # any registered collective

        def resolve(rank, pend):
            """Attempt to complete ``pend``; NOTHING when still blocked."""
            kind = pend[0]
            if kind == "recv":
                got = take(rank, pend[1], pend[2])
                return got[1] if got is not None else NOTHING
            if kind == "recv_any":
                got = take(rank, None, pend[1])
                return got if got is not None else NOTHING
            if kind == "exchange_wait":
                _, srcs, tag, got = pend
                for s in srcs:
                    if s not in got:
                        m = take(rank, s, tag)
                        if m is not None:
                            got[s] = m[1]
                return got if len(got) == len(srcs) else NOTHING
            if kind == "collective":
                return coll.resolve(rank, pend)
            raise ValueError(kind)

        while len(done) < self.n:
            progressed = False
            for r in range(self.n):
                if r in done:
                    continue
                if pending[r] is None:
                    send_val = None
                else:
                    send_val = resolve(r, pending[r])
                    if send_val is NOTHING:
                        continue
                    pending[r] = None
                try:
                    op = gens[r].send(send_val)
                except StopIteration as stop:
                    done[r] = stop.value if stop.value is not None \
                        else states[r]
                    progressed = True
                    continue
                pending[r] = intake(r, op)
                progressed = True
            if not progressed:
                blocked = {r: pending[r] for r in range(self.n)
                           if r not in done}
                raise RuntimeError(f"deadlock at step {t}: {blocked}")

        return {r: done[r] for r in range(self.n)}, None
