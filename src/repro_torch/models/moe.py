"""Mixture-of-Experts FFN, top-k routing with sort-based dispatch (port of
``repro/models/moe.py:26-64, 121-141``, the local path).

Each sequence is routed on its own, as the reference vmaps its dispatch
over the batch: token s's k choices are the assignments s*k .. s*k+k-1,
grouped by expert with a stable sort, and each expert keeps the first
``capacity`` of its group in token order. The expert buffers keep the
reference's shape, ``[E, cap + 1, d]`` a sequence, row ``cap`` taking the
dropped assignments, and every expert multiplies its whole buffer (the
buffers of the batch side by side: ``[E, B * (cap + 1), d]``, one batched
matmul a weight).

Where the reference relies on an order, the port fixes it explicitly:
``lax.top_k`` puts the lower expert index first among equal
probabilities, here a stable descending sort does; the argsort that groups
by expert is stable on both sides. Nothing is scattered, so every
result is deterministic on the card: the rank's inverse permutation is a
gather through a sort, and the buffers are gathered too. Slot j of expert e takes the j-th assignment of
e's group in the sorted order, where the group has one; empty slots and
the drop row are zero (the reference's drop row holds a dropped token, but
its rows reach the output only times a weight of 0). The combine adds the k
weighted expert rows of a token one at a time in the model dtype, from
zero, as the reference's ``zeros.at[tok].add`` does.

Training reads ``moe_aux_loss``, the reference's load-balancing loss on
the first layer's router (``moe.py:144-152``). The backward of the
gathers is a scatter-add (``index_select``'s and the advanced index's):
under ``torch.use_deterministic_algorithms(True)`` PyTorch runs both as a
sorted, ordered accumulation, so a train step is bitwise the same each
run (``chip_smoke.py``'s MoE train phase holds a clean and a replicated
run to one final state).

On a mesh (``distributed.context.activate_mesh``) ``moe_apply`` takes the
reference's shard_map path, ``_moe_apply_sharded`` (``moe.py:95-118``):
the batch over the data axes, the experts' d_ff over ``model``, the local
dispatch on each rank's shards, and one all-reduce over ``model`` after
the down-projection (a functional collective, so a traced step sees it).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context, parallel

F32 = torch.float32


def moe_params(cfg: ModelConfig, dtype, device) -> dict:
    """Uninitialised router and expert weights (``init`` fills them)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": torch.empty((d, e), dtype=dtype, device=device),
            "wi": torch.empty((e, d, f), dtype=dtype, device=device),
            "wg": torch.empty((e, d, f), dtype=dtype, device=device),
            "wo": torch.empty((e, f, d), dtype=dtype, device=device)}


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Assignments an expert keeps of one sequence of ``seq`` tokens."""
    per = seq * cfg.n_experts_per_tok / cfg.n_experts
    cap = int(per * cfg.capacity_factor) + 1
    return min(max(cap, cfg.n_experts_per_tok), seq)


def dispatch(cfg: ModelConfig, gates_logits: torch.Tensor):
    """Route each sequence. gates_logits: [..., S, E].

    Returns (flat_e, slot, w, keep, cap): the expert, buffer slot, f32
    combine weight and kept flag of each assignment, each [..., S*k]
    (token s's choices at s*k .. s*k+k-1, best first), and the capacity;
    ``slot == cap`` for a dropped assignment. The tables of the
    reference's ``_dispatch_one``, for every leading index."""
    return _dispatch(cfg, gates_logits)[:5]


def _dispatch(cfg: ModelConfig, gates_logits: torch.Tensor):
    """``dispatch``'s tables, then the grouping: ``order`` (the stable
    argsort of flat_e) and ``sorted_e`` (flat_e in that order)."""
    k = cfg.n_experts_per_tok
    seq = gates_logits.shape[-2]
    cap = capacity(cfg, seq)
    probs = torch.softmax(gates_logits.to(F32), dim=-1)
    # lax.top_k's order: larger first, the lower index first among equals
    top_e = torch.argsort(probs, dim=-1, descending=True, stable=True)
    top_e = top_e[..., :k]
    top_w = probs.gather(-1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    lead = gates_logits.shape[:-2]
    flat_e = top_e.reshape(*lead, seq * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)      # group by expert
    sorted_e = flat_e.gather(-1, order)
    # rank within the expert group = index - first index of this expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(seq * k, device=flat_e.device) - first
    # rank[order] = rank_sorted, as a gather through the inverse permutation
    rank = rank_sorted.gather(-1, torch.argsort(order, dim=-1))

    keep = rank < cap
    slot = torch.where(keep, rank, cap)                      # cap row = dropped
    return flat_e, slot, top_w.reshape(*lead, seq * k), keep, cap, order, \
        sorted_e


def buffers(x: torch.Tensor, order, sorted_e, e: int, k: int, cap: int):
    """The expert buffers [E, B, cap+1, d] of x [B, S, d], gathered: slot
    j of expert e holds the token of the j-th assignment of e's group in
    ``order``, where the group has one; the other slots and row ``cap``
    are zero."""
    b, s, d = x.shape
    experts = torch.arange(e + 1, device=x.device).expand(b, e + 1)
    bounds = torch.searchsorted(sorted_e, experts.contiguous())  # [B, E+1]
    j = torch.arange(cap + 1, device=x.device)
    pos = bounds[:, :e, None] + j                            # [B, E, cap+1]
    filled = (j < cap) & (pos < bounds[:, 1:, None])
    src = order.gather(-1, pos.clamp(max=s * k - 1).view(b, -1))
    row = src.view(b, e, cap + 1) // k + \
        s * torch.arange(b, device=x.device)[:, None, None]
    buf = x.reshape(b * s, d).index_select(
        0, row.transpose(0, 1).reshape(-1)).view(e, b, cap + 1, d)
    return buf.masked_fill_(~filled.transpose(0, 1)[..., None], 0)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]: ``_moe_apply_sharded`` when a mesh with
    a ``model`` axis of more than one device is active, as the reference
    takes it under ``_mesh_for_shard_map()``, else the local path."""
    mesh = _mesh_for_shard_map()
    if mesh is not None:
        return _moe_apply_sharded(cfg, p, x, mesh)
    return _moe_apply_local(cfg, p, x)


def _mesh_for_shard_map():
    """The active mesh if it has a ``model`` axis of more than one device
    (the explicit-TP path), else None."""
    mesh = context.current_mesh()
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()) or \
            mesh.size(mesh.mesh_dim_names.index("model")) <= 1:
        return None
    return mesh


def _moe_apply_sharded(cfg: ModelConfig, p, x, mesh):
    """The reference's shard_map path over DTensors: x's batch over the
    data axes (replicated where the batch does not divide, as tiny decode
    batches), the router replicated, ``wi``/``wg`` [E, d, f] and ``wo``
    [E, f, d] sharded on f over ``model``; each rank runs the local
    dispatch on its shards and the partial outputs are summed over
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    batch = tuple(a for a in context.current_batch_axes() if a in names
                  and mesh.size(names.index(a)) > 1)
    bsz = 1
    for a in batch:
        bsz *= mesh.size(names.index(a))
    if x.shape[0] % max(bsz, 1):
        batch = ()
    model = names.index("model")

    def place(dim=None, sharded=()):
        return tuple(Shard(dim) if a in sharded else Replicate()
                     for a in names) if dim is not None else \
            tuple(Replicate() for _ in names)
    bspec = place(0, batch)
    ff = {"wi": place(2, ("model",)), "wg": place(2, ("model",)),
          "wo": place(1, ("model",))}

    def inner(xs, router, wi, wg, wo):
        y = _moe_apply_local(
            cfg, {"router": router, "wi": wi, "wg": wg, "wo": wo}, xs)
        return parallel.AllReduce.apply(y, (mesh, model))

    f = local_map(inner, out_placements=list(bspec),
                  in_placements=tuple(list(pl) for pl in (
                      bspec, place(), ff["wi"], ff["wg"], ff["wo"])),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(x, p["router"], p["wi"], p["wg"], p["wo"])


def _moe_apply_local(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d] (the reference's ``_moe_apply_local``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    logits = x @ p["router"]
    flat_e, slot, w, keep, cap, order, sorted_e = _dispatch(cfg, logits)
    rows = buffers(x, order, sorted_e, e, k, cap).view(e, b * (cap + 1), d)
    h = torch.bmm(rows, p["wi"])
    g = torch.bmm(rows, p["wg"])
    h = h * torch.nn.functional.silu(g.to(F32)).to(h.dtype)
    out_buf = torch.bmm(h, p["wo"]).view(e, b, cap + 1, d)
    seq_of = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    gathered = out_buf[flat_e, seq_of, slot]                 # [B, S*k, d]
    gathered = gathered * (w * keep)[..., None].to(gathered.dtype)
    gathered = gathered.view(b, s, k, d)
    y = torch.zeros_like(x)
    for j in range(k):                  # one add an assignment, in order
        y = y + gathered[:, :, j]
    return y


def moe_aux_loss(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balancing loss of the reference
    (``moe.py:144-152``): E * sum(frac * imp), frac the share of the top-k
    assignments each expert gets (a one-hot mean, no gradient) and imp its
    mean router probability; the router product in the model dtype, then
    f32."""
    logits = (x @ p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: larger first, the lower index first among equals
    top_e = torch.argsort(probs, dim=-1, descending=True,
                          stable=True)[..., :cfg.n_experts_per_tok]
    frac = torch.nn.functional.one_hot(top_e, cfg.n_experts).to(F32) \
        .mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * imp)
