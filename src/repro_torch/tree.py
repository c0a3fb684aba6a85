"""Stand-ins for the ``jax.tree`` utilities over dict/list/tuple trees
(NamedTuples keep their type).

``copy_tree`` is the one the FT layer depends on: a replica's state must
own its buffers. It clones every tensor and copies every numpy array, so a
step that writes its state in place (the decode loop's ring cache) can
never reach the other copy.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf; dicts, lists and tuples keep their
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _copy_leaf(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def copy_tree(tree):
    """Deep copy that owns its storage: ``clone()`` for tensors, ``copy()``
    for numpy arrays; immutable leaves (ints, floats, None) are shared."""
    return tree_map(_copy_leaf, tree)
