"""Partitioning rules: each of the port's tensors -> its placement on a
``DeviceMesh`` (port of ``repro/distributed/sharding.py``).

Megatron-style tensor parallelism over the ``model`` axis; batch over
``data`` (and ``pod`` when the multi-pod mesh runs data-parallel; in the
paper's replication mode the ``pod`` axis is absent from every spec: pod 1
is the replica slice and computes the same values). A dimension that does
not divide by its mesh axis is replicated instead, so one rule table
serves all 10 architectures.

The reference's rules are right-aligned to its stacked leaves ([L, ...],
[G, K, ...]), whose leading stacked dims they leave replicated. The port
keeps one tensor a block (``layers.3.attn.wq``), so a rule is looked up by
the reference's path of the leaf the tensor stacks into
(``models.convert.stack_plan``: ``layers/attn/wq``) and fitted to the
tensor's own shape: the same spec as the stacked leaf's, less its leading
dims.

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the batch over ``pod`` and ``data``), the
reference's ``PartitionSpec`` as a plain tuple. ``placements`` turns it
into DTensor placements, one a mesh dim: ``Shard(dim)`` or
``Replicate()``.

``constrain_batch`` pins a tensor's batch placement on the axes that
``distributed.context.use_batch_axes`` set and is a no-op without a
mesh.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

from repro_torch.distributed.context import current_batch_axes
from repro_torch.distributed.parallel import dtensor_type
from repro_torch.models.convert import _split_name

# leaf name -> per-dim logical axes, right-aligned to the shape
_PARAM_RULES = {
    # embeddings
    "embed":    ("model", None),
    "unembed":  (None, "model"),
    # attention
    "wq":       (None, "model", None),
    "wk":       (None, "model", None),
    "wv":       (None, "model", None),
    "wo":       ("model", None, None),
    "bq":       ("model", None),
    "bk":       ("model", None),
    "bv":       ("model", None),
    "gate":     (),
    # dense mlp
    "wi":       (None, "model"),
    "wg":       (None, "model"),
    # moe (router replicated; experts sharded on d_ff)
    "router":   (None, None),
    # xlstm
    "w_up":     (None, "model"),
    "w_down":   ("model", None),
    "w_gates":  (None, "model"),
    "b_gates":  ("model",),
    "r_gates":  (None, None, "model"),
    "bf":       (None,),
    # mamba2
    "in_z":     (None, "model"),
    "in_x":     (None, "model"),
    "in_b":     (None, None),
    "in_c":     (None, None),
    "in_dt":    (None, "model"),
    "conv_w":   (None, None),
    "conv_b":   (None,),
    "a_log":    (None,),
    "d_skip":   (None,),
    "dt_bias":  (None,),
    "out_proj": ("model", None),
    # norms
    "scale":    (None,),
}

# context-sensitive overrides: (an ancestor, leaf) pairs
_CTX_RULES = {
    # MoE expert weights: [E, d, f] / [E, f, d]: shard d_ff on model
    ("ffn", "wi"): (None, None, "model"),
    ("ffn", "wg"): (None, None, "model"),
    ("ffn", "wo"): (None, "model", None),
    # xlstm mLSTM q/k/v are square [d, d]
    ("mlstm", "wq"): (None, "model"),
    ("mlstm", "wk"): (None, "model"),
    ("mlstm", "wv"): (None, "model"),
    ("mlstm", "wi"): (None, None),      # input-gate proj [d, H], H tiny
    ("mlstm", "wf"): (None, None),
}

Spec = Tuple


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _fit(axes: Sequence, shape: Sequence[int], axis_sizes: dict) -> Spec:
    """Right-align the rule to the shape; drop non-dividing mesh axes."""
    rule = list(axes)
    ndim = len(shape)
    full = [None] * (ndim - len(rule)) + rule if len(rule) <= ndim else \
        rule[len(rule) - ndim:]
    spec = []
    for dim, ax in zip(shape, full):
        if ax is None:
            spec.append(None)
        else:
            size = axis_sizes.get(ax, 1)
            spec.append(ax if (size > 1 and dim % size == 0) else None)
    return tuple(spec)


def path_pspec(names: Sequence[str], shape: Sequence[int],
               axis_sizes: dict) -> Spec:
    """The spec of a leaf at the reference's path ``names`` (a tuple of
    keys) of ``shape``: the reference's ``param_pspec``."""
    names = list(names)
    leaf_name = names[-1] if names else ""
    for i in range(len(names) - 1):
        key = (names[i], leaf_name)
        if key in _CTX_RULES:
            return _fit(_CTX_RULES[key], shape, axis_sizes)
    if leaf_name in _PARAM_RULES:
        return _fit(_PARAM_RULES[leaf_name], shape, axis_sizes)
    return tuple([None] * len(shape))   # replicate unknowns


def param_pspec(name: str, shape: Sequence[int], axis_sizes: dict) -> Spec:
    """The spec of the port's tensor ``name`` (a state-dict name, such as
    ``layers.3.attn.wq``) of ``shape``: the rule of the reference's leaf
    that the tensor stacks into, fitted to the tensor's own shape."""
    path, _ = _split_name(name)
    return path_pspec(path, shape, axis_sizes)


def param_pspecs(shapes: Dict[str, Sequence[int]], mesh) -> Dict[str, Spec]:
    """{name: spec} for a state dict's {name: shape} on ``mesh``."""
    sizes = mesh_axes(mesh)
    return {k: param_pspec(k, s, sizes) for k, s in shapes.items()}


def _names(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim d names its axis (alone or in a tuple),
    else ``Replicate()``. A mesh dim named ``"pod+data"`` (the two batch
    axes flattened into one) shards the dim that names both."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        members = tuple(axis.split("+"))
        dim = next((d for d, ax in enumerate(spec)
                    if _names(ax) == members or (
                        len(members) == 1 and axis in _names(ax))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec,
                axis_sizes: dict) -> Tuple[int, ...]:
    """A shard's shape: each dim divided by the sizes of the axes that
    shard it (the rules shard only dims that divide)."""
    out = []
    for dim, ax in zip(shape, spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        for a in axes:
            dim //= axis_sizes[a]
        out.append(dim)
    return tuple(out)


# -- activations / inputs ----------------------------------------------------

def batch_axes(mesh, replication_axis: str = "none") -> tuple:
    """Mesh axes that shard the global batch. In the paper's replication
    mode (``pod``) the pod axis is excluded everywhere: pod 1 replays pod
    0; a split mesh's ``rep`` axis is not a batch axis."""
    axes = [a for a in mesh.mesh_dim_names
            if set(a.split("+")) <= {"pod", "data"}]
    if replication_axis == "pod" and "pod" in axes:
        axes.remove("pod")
    return tuple(axes)


def input_pspec(shape: Sequence[int], mesh,
                replication_axis: str = "none") -> Spec:
    """Shard dim 0 (the global batch) over the batch axes when it
    divides."""
    ba = batch_axes(mesh, replication_axis)
    sizes = mesh_axes(mesh)
    n = 1
    for a in ba:
        n *= sizes[a]
    if shape and shape[0] % n == 0 and n > 1:
        return (_axis(ba),) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def _axis(axes: tuple):
    """A spec entry for ``axes``: one name alone, several as a tuple (a
    ``PartitionSpec``'s normal form)."""
    return axes[0] if len(axes) == 1 else tuple(axes)


# -- serve caches / recurrent state ------------------------------------------

def cache_pspec(leaf_name: str, shape: Sequence[int], axis_sizes: dict,
                global_batch: int, replication_axis: str = "none") -> Spec:
    """KV caches [.., B, S, H, D]: batch over data when it divides, else
    the sequence; heads over model (head_dim as the fallback). Recurrent
    states: batch over data, the first feature dim that divides over
    model. The reference's ``cache_pspec`` for a leaf named
    ``leaf_name``."""
    shape = tuple(shape)
    data = [a for a in ("pod", "data") if a in axis_sizes]
    if replication_axis == "pod" and "pod" in data:
        data.remove("pod")
    dsz = 1
    for a in data:
        dsz *= axis_sizes[a]
    data_ax = _axis(tuple(data)) if dsz > 1 else None
    msz = axis_sizes.get("model", 1)
    spec = [None] * len(shape)
    bi = next((i for i, d in enumerate(shape) if d == global_batch), -1)
    if leaf_name in ("k", "v"):
        if data_ax and bi >= 0 and shape[bi] % dsz == 0:
            spec[bi] = data_ax
        elif data_ax and len(shape) >= 3 and shape[-3] % dsz == 0:
            spec[-3] = data_ax      # shard the sequence/window dim
        if shape[-2] % msz == 0 and msz > 1:
            spec[-2] = "model"
        elif shape[-1] % msz == 0 and msz > 1:
            spec[-1] = "model"
        return tuple(spec)
    if leaf_name == "pos":
        if data_ax and bi >= 0 and shape[bi] % dsz == 0:
            spec[bi] = data_ax
        elif data_ax and shape[-1] % dsz == 0:
            spec[-1] = data_ax
        return tuple(spec)
    if leaf_name == "idx":
        return tuple(spec)
    if data_ax and bi >= 0 and shape[bi] % dsz == 0:
        spec[bi] = data_ax
    if len(shape) - (bi + 1) >= 1 and msz > 1:
        for i in range(bi + 1 if bi >= 0 else 0, len(shape)):
            if spec[i] is None and shape[i] % msz == 0 and shape[i] >= msz:
                spec[i] = "model"
                break
    return tuple(spec)


def cache_leaves(tree, path=()) -> Iterable[Tuple[tuple, object]]:
    """(path, tensor) of every tensor in a cache tree of dicts and lists
    (the host ints, such as a ring's ``idx``, are not tensors)."""
    import torch
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from cache_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from cache_leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def cache_pspecs(cache, mesh, global_batch: int,
                 replication_axis: str = "none") -> Dict[tuple, Spec]:
    """{path: spec} of every tensor of the port's cache tree, each ruled
    by the name of its last dict key."""
    sizes = mesh_axes(mesh)
    return {path: cache_pspec(next(str(k) for k in reversed(path)
                                   if isinstance(k, str)), t.shape, sizes,
                              global_batch, replication_axis)
            for path, t in cache_leaves(cache)}


# -- in-model batch pinning --------------------------------------------------

def constrain_batch(x, batch_dims: int = 1):
    """Pin x's dim 0 to the batch mesh axes (every other dim replicated),
    as the reference's ``with_sharding_constraint``; x itself when it is
    not a DTensor (no mesh) or its batch does not divide."""
    cls = dtensor_type()
    if cls is None or not isinstance(x, cls) or x.ndim < 1:
        return x
    mesh = x.device_mesh
    axes = tuple(a for a in current_batch_axes()
                 if a in mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    if not axes or x.shape[0] % n:
        return x
    spec = (axes,) + (None,) * (x.ndim - 1)
    return x.redistribute(mesh, placements(spec, mesh))
