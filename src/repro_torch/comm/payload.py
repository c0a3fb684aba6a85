"""Copy-on-write payload capture for the transport hot path.

The pre-PR transport deep-copied every payload twice per send (once for
capture, once for the intercomm fill-in).  That is O(payload) per message
and dominated the step cost at scale.  The CoW scheme replaces both
copies with *freezing*:

  * ``freeze_payload`` walks the payload once and sets
    ``flags.writeable = False`` on every ndarray it contains.  The frozen
    object is then shared — sender log, computational delivery, and
    replica fill-in all reference the same payload;
  * mutation attempts (by the sender after the send, or by a receiver on
    a delivered payload) raise ``ValueError: assignment destination is
    read-only`` instead of silently corrupting the log — the MPI contract
    (buffers are immutable once handed to the library) made loud;
  * a copy happens only when someone actually needs a writeable buffer:
    checkpoint restore (``structural_copy`` with ``mutable=True``).

Two payload shapes canNOT be captured by freezing, and fall back to a
real copy so sharing never corrupts the log:

  * an ndarray **view of a writeable base** (``arr.base`` writeable) —
    freezing the view leaves the underlying buffer writeable through the
    base and sibling views.  The canonical stencil app sends a slice of
    state it keeps updating, which real MPI permits (the buffer is
    reusable once ``MPI_Send`` returns), so the view's contents are
    captured with ``ndarray.copy`` instead;
  * an **opaque object** (dict/list/tuple subclass, namedtuple,
    dataclass, custom class) — the walker cannot see inside it, so
    ``freeze_payload`` reports the payload as not fully frozen and the
    transport restores the pre-CoW ``copy.deepcopy`` isolation for that
    send.  Only fully-frozen payloads are ever shared.

``structural_copy`` is the checkpoint-time replacement for
``copy.deepcopy``: it shares frozen (read-only) arrays, copies writeable
ones with ``ndarray.copy`` (no deepcopy machinery), and falls back to
``copy.deepcopy`` only for opaque objects.

The PyTorch port's copy of ``repro/comm/payload.py``.  A ``torch.Tensor``
has no read-only flag, so it cannot be frozen, and so it cannot be shared
either: it is captured with ``detach().clone()`` on its own device — the
fallback the reference takes for a view of a writeable buffer — and that
clone is the sender log's alone.  Every delivery (the computational copy,
the intercomm fill-in, a replay) gets a clone of its own through
``own_tensors``, so a receiver that writes into its tensor changes neither
the log, nor a later replay, nor its twin's copy.  The sender's tensor is
never shared (mutating it after the send changes nothing), and a tensor
that cannot be cloned raises instead of being shared.  Numpy payloads are
captured and shared exactly as in the reference.  ``structural_copy`` of a
tensor is a clone, with or without ``mutable``.
"""
from __future__ import annotations

from typing import Any, Tuple

import copy

import numpy as np
import torch


def _base_writeable(base: Any) -> bool:
    """Can the buffer owner ``base`` (of an ndarray view) still be
    written?  Unknown owner types are assumed writeable — the safe
    direction is a copy, never sharing a mutable buffer."""
    if isinstance(base, np.ndarray):
        return base.flags.writeable
    if isinstance(base, memoryview):
        return not base.readonly
    if isinstance(base, (bytes, str)):
        return False
    return True


def freezable(payload: Any) -> bool:
    """True when ``freeze_payload`` fully understands ``payload``:
    ndarrays, numpy scalars, and immutable leaves inside exact-type
    dict/list/tuple containers.  Anything else (subclasses, custom
    objects) needs deepcopy isolation on the send path.  Tensors count
    as understood: they are captured by a clone."""
    if isinstance(payload, (np.ndarray, torch.Tensor)):
        return True
    t = type(payload)
    if t is dict:
        return all(freezable(v) for v in payload.values())
    if t in (list, tuple):
        return all(freezable(v) for v in payload)
    if payload is None or t in (int, float, bool, str, bytes, complex):
        return True
    return isinstance(payload, np.generic)


def _capture(t: torch.Tensor) -> torch.Tensor:
    """The transport's own copy of a tensor payload, on its device."""
    try:
        return t.detach().clone()
    except RuntimeError as e:
        raise TypeError(f"cannot capture a {type(t).__name__} payload "
                        f"({t.dtype}, {t.device}) by a clone; refusing to "
                        f"share the sender's tensor") from e


def _freeze(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _capture(obj)
    if isinstance(obj, np.ndarray):
        if obj.base is not None and _base_writeable(obj.base):
            # view of a writeable buffer: freezing the view would not
            # protect the buffer (base / sibling views stay writeable),
            # so capture the contents — MPI_Send's buffer-reuse contract
            obj = obj.copy()
        obj.flags.writeable = False
        return obj
    t = type(obj)
    if t is dict:
        return {k: _freeze(v) for k, v in obj.items()}
    if t is list:
        return [_freeze(v) for v in obj]
    if t is tuple:
        return tuple(_freeze(v) for v in obj)
    return obj


def own_tensors(payload: Any) -> Any:
    """``payload`` with every tensor in it (inside exact-type
    dict/list/tuple containers) replaced by a clone on its device: a
    delivery's own copy of a captured payload.  A payload that holds no
    tensor is returned as it is (frozen ndarrays stay shared)."""
    if isinstance(payload, torch.Tensor):
        return _capture(payload)
    t = type(payload)
    if t is dict:
        out = {k: own_tensors(v) for k, v in payload.items()}
        if all(out[k] is v for k, v in payload.items()):
            return payload
        return out
    if t in (list, tuple):
        items = [own_tensors(v) for v in payload]
        if all(a is b for a, b in zip(items, payload)):
            return payload
        return items if t is list else tuple(items)
    return payload


def freeze_payload(payload: Any) -> Tuple[Any, bool]:
    """Capture ``payload`` for sharing; returns ``(captured, frozen)``.

    ``frozen=True``: every ndarray in ``captured`` is read-only (frozen
    in place, or copied first when it was a view of a writeable base)
    and the object is safe to share between the sender log, the
    delivery, and the replica fill-in; every tensor is a fresh clone,
    which only the sender log may keep (deliveries take ``own_tensors``).
    Non-view arrays are frozen *in place*: later in-place writes through
    the sender's own reference raise.  Writes through a pre-existing sibling view of a read-only
    base are still undetectable — don't do that.

    ``frozen=False``: the payload contains objects the walker does not
    recognize; ``captured`` is the payload unchanged (nothing frozen),
    and the caller must isolate it with ``copy.deepcopy`` before
    sharing, exactly as the pre-CoW transport did."""
    if not freezable(payload):
        return payload, False
    return _freeze(payload), True


def structural_copy(obj: Any, *, mutable: bool = False) -> Any:
    """Snapshot-grade copy without deepcopy's memo machinery.

    Read-only (frozen) arrays are shared — nobody can mutate them, so a
    snapshot holding the same object is as isolated as a copy.  Writeable
    arrays are copied with ``ndarray.copy``.  With ``mutable=True`` every
    array in the result is an independent writeable copy (checkpoint
    restore hands states back to apps that may mutate them in place).

    Exact-type dict/list/tuple containers are rebuilt; subclasses and
    any other object fall back to ``copy.deepcopy`` so semantics never
    change for payloads the fast path does not understand.  A tensor is
    always cloned (no flag says it cannot change)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, np.ndarray):
        if not mutable and not obj.flags.writeable:
            return obj
        return obj.copy()
    t = type(obj)
    if t is dict:
        return {k: structural_copy(v, mutable=mutable)
                for k, v in obj.items()}
    if t is list:
        return [structural_copy(v, mutable=mutable) for v in obj]
    if t is tuple:
        return tuple(structural_copy(v, mutable=mutable) for v in obj)
    if obj is None or t in (int, float, bool, str, bytes, complex):
        return obj
    if isinstance(obj, np.generic):            # numpy scalars are immutable
        return obj
    # the one sanctioned fallback: opaque objects (subclasses, custom
    # classes) keep full deepcopy semantics
    return copy.deepcopy(obj)  # repro: allow[deepcopy]
