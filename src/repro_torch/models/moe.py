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

Not ported here: the mesh path ``_moe_apply_sharded`` (ROADMAP.md, Queue 1
item 10) and ``moe_aux_loss``, which only training reads (item 5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

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
