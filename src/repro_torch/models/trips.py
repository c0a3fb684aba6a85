"""How many iterations a model's Python loop over the sequence runs.

The xLSTM's sLSTM steps token by token and its mLSTM chunk by chunk; at
the dry run's lengths (32,768 tokens a prefill) tracing every iteration
would take minutes. ``launch/op_cost.py`` runs such a loop for 1 and 2
iterations (``folded``) and extrapolates: each loop asks ``trips(kind,
n)`` how many of its ``n`` iterations to run and ``pad``s what it
collected back to ``n`` entries (detached copies of the last). Outside
``folded`` every loop runs in full and ``pad`` returns its list
unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars

_TRIPS = contextvars.ContextVar("repro_torch_trips", default=None)


def trips(kind: str, n: int) -> int:
    """The iterations to run of a loop of ``n`` (``kind`` names the loop:
    ``"slstm"``, ``"mlstm"``)."""
    over = _TRIPS.get()
    if over is None or kind not in over:
        return n
    return min(n, over[kind])


def pad(items: list, n: int) -> list:
    """``items`` padded to ``n`` entries with its last, detached (no
    gradient flows into the padding: the cost of a traced step stays
    affine in the iterations run, and cheap to trace)."""
    if len(items) >= n:
        return items
    return items + [items[-1].detach()] * (n - len(items))


@contextlib.contextmanager
def folded(counts: dict):
    """Run each loop named in ``counts`` for that many iterations."""
    tok = _TRIPS.set(dict(counts))
    try:
        yield
    finally:
        _TRIPS.reset(tok)
