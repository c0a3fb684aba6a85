"""The models' regions over DTensors (the dry run on a mesh).

Each function here is what a model layer runs in place of its local code
when a mesh is active (``distributed.context.current_mesh()``): the
vocab-parallel embedding lookup and label pick, the gather of a feature
dim whose shards would split a head, a region run on each rank's batch
shard (``local_map``), and the functional all-reduce they end with. None
of them runs without a mesh; ``to_local`` and ``reduce_grads`` pass plain
tensors through, so the optimizer takes one path either way.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.distributed.context import current_batch_axes


def dtensor_type():
    """``DTensor`` if ``torch.distributed.tensor`` is imported, else None
    (no tensor can be one then; the check costs no import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def to_local(t):
    """A DTensor's local shard (sharing its storage), any other tensor
    itself."""
    cls = dtensor_type()
    return t.to_local() if cls is not None and isinstance(t, cls) else t


def reduce_grads(grads: dict, params: dict) -> dict:
    """Each DTensor gradient redistributed to its parameter's placements
    (the data-parallel all-reduce, or reduce-scatter for a sharded
    parameter, of the gradients' partial sums); plain tensors as they
    are."""
    cls = dtensor_type()
    if cls is None:
        return grads
    return {k: (g.redistribute(params[k].device_mesh, params[k].placements)
                if isinstance(g, cls) else g) for k, g in grads.items()}


class AllReduce(torch.autograd.Function):
    """The sum of the ranks' partial results over a mesh dim (a
    functional all-reduce, so a traced step sees it); its gradient is the
    result's, on every rank."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.all_reduce(y, "sum", group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def sharded_lookup(table, tokens, mesh):
    """Megatron's vocab-parallel embedding: each rank looks up the tokens
    of its slice of the vocab (``table``'s rows sharded over ``model``, as
    the rules shard ``embed``), zeroes the others, and the rows are summed
    over ``model``; the result keeps the tokens' batch placement."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    t_place = list(table.placements)
    if "model" not in names or not t_place[names.index("model")].is_shard():
        return table[tokens]
    model = names.index("model")
    tok_place = list(tokens.placements)
    out_place = [Replicate() if i == model else p
                 for i, p in enumerate(tok_place)]

    def inner(tab, tok):
        rows = tab.shape[0]
        lo = mesh.get_local_rank("model") * rows
        local = tok - lo
        hit = (local >= 0) & (local < rows)
        y = tab[local.clamp(0, rows - 1)] * hit[..., None].to(tab.dtype)
        return AllReduce.apply(y, (mesh, model))
    return local_map(inner, out_placements=out_place,
                     in_placements=(t_place, tok_place), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def sharded_pick(logits, labels, mesh):
    """The label's logit where the vocab dim is sharded over ``model``:
    each rank picks the labels in its slice of the vocab, zeroes the
    others, and the picks are summed over ``model`` (the vocab-parallel
    cross-entropy's pick; DTensor's own gather of a vocab-sharded tensor
    cannot be reduced afterwards)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    if "model" not in names:
        return logits.gather(-1, labels[..., None].long())[..., 0]
    model = names.index("model")
    lab_place = [p if i != model and p.is_shard() and p.dim == 0
                 else Replicate() for i, p in enumerate(logits.placements)]
    l_place = [Shard(logits.ndim - 1) if i == model else p
               for i, p in enumerate(lab_place)]

    def inner(lg, lab):
        cols = lg.shape[-1]
        local = lab.long() - mesh.get_local_rank("model") * cols
        hit = (local >= 0) & (local < cols)
        pick = lg.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
        return AllReduce.apply(pick * hit.to(pick.dtype), (mesh, model))
    return local_map(inner, out_placements=lab_place,
                     in_placements=(l_place, lab_place), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def whole_heads(t, heads: int, mesh):
    """``t`` [..., H * dh] gathered over ``model`` when its feature dim is
    split there into pieces that do not hold whole heads (the xLSTM's 4
    heads on 16 ranks), so a view into [..., H, dh] splits no head; else
    ``t`` itself."""
    if "model" not in mesh.mesh_dim_names:
        return t
    model = mesh.mesh_dim_names.index("model")
    pl = list(getattr(t, "placements", ()))
    if pl and pl[model].is_shard() and heads % mesh.size(model):
        from torch.distributed.tensor import Replicate
        pl[model] = Replicate()
        t = t.redistribute(t.device_mesh, pl)
    return t


def batch_parallel(fn, args, batched, n_out: int, mesh):
    """``fn(*args)`` on each rank's batch shard: ``local_map`` with the
    batch (dim 0 of each arg whose ``batched`` flag is True, and of each
    of the ``n_out`` outputs) over the batch axes where it divides and
    everything else replicated, so the region runs as plain local ops. For
    loops over the sequence whose heads cannot split over ``model``: the
    model ranks run the region whole, after one all-gather of its inputs a
    call. ``batched`` holds a flag an arg (None for a non-tensor)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    axes = [a for a in current_batch_axes() if a in names]
    lead = next(a for a, f in zip(args, batched) if f)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    split = lead.shape[0] % n == 0
    bp = [Shard(0) if split and name in axes else Replicate()
          for name in names]
    rp = [Replicate()] * len(names)

    def placed(a):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
            return DTensor.from_local(a, mesh, rp, run_check=False)
        return a
    in_pl = tuple(None if f is None else (bp if f else rp) for f in batched)
    out_pl = bp if n_out == 1 else tuple(bp for _ in range(n_out))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        *(placed(a) for a in args))
