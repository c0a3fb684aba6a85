"""The ambient mesh and batch axes that the models read.

``activate_mesh(mesh)`` installs a ``DeviceMesh`` for a region (the dry
run's); ``current_mesh()`` is None outside one, and then every model runs
its local path. ``use_batch_axes`` sets which mesh axes shard the batch
inside the models (('pod', 'data') for multi-pod data parallelism;
('data',) in replication mode). Both are context variables: nothing here
imports ``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)
_BATCH_AXES = contextvars.ContextVar("repro_torch_batch_axes",
                                     default=("data",))


def current_mesh():
    """The mesh ``activate_mesh`` installed, or None."""
    return _MESH.get()


@contextlib.contextmanager
def activate_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the models (None: none)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


@contextlib.contextmanager
def use_batch_axes(axes):
    """Set which mesh axes shard the batch for in-model placements."""
    tok = _BATCH_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(tok)


def current_batch_axes() -> tuple:
    return _BATCH_AXES.get()
