"""Workload protocol and its adapters (port of ``repro/ft/workload.py``:
``TrainWorkload`` and ``DecodeWorkload``; ``SimAppWorkload`` comes with
the simulated runtime, ROADMAP.md Queue 1 item 9).

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

from typing import Any, Callable, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.tree import copy_tree

__all__ = ["Workload", "TrainWorkload", "DecodeWorkload", "copy_tree"]


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
