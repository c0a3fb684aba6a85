"""Plain float32 reference of the MoE decoder (Mixtral) as the port runs
it (``configs/<name>.json``'s ``port`` section): per layer an RMSNorm,
RoPE attention with grouped KV heads, an RMSNorm and the sparse experts,
each added to the stream; a final RMSNorm and the LM head; the loss adds
``aux_loss_weight`` x the load-balancing loss of the first layer's router
on the final normed stream.

Routing, per sequence: softmax over the router's logits, the top k by
probability (the lower expert first among equals), their weights
renormalised to sum to 1. Each expert keeps the first ``capacity`` of
its assignments in (token, choice) order, capacity being
``min(max(int(S k / E x capacity_factor) + 1, k), S)``; a dropped
assignment adds nothing. An expert is a SwiGLU MLP (wi, wg, wo) applied
to its kept tokens only. The load-balancing loss is E x sum over experts
of (the share of top-k assignments it gets) x (its mean probability)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import attention, lm_loss, rmsnorm, swiglu


def capacity(m: dict, seq: int) -> int:
    k, e = m["n_experts_per_tok"], m["n_experts"]
    cap = int(seq * k / e * m["capacity_factor"]) + 1
    return min(max(cap, k), seq)


def route(m: dict, probs: torch.Tensor):
    """probs [B,S,E] -> (experts [B,S,k], weights [B,S,k], kept [B,S,k])."""
    k, e = m["n_experts_per_tok"], m["n_experts"]
    b, s, _ = probs.shape
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    onehot = F.one_hot(top_e.reshape(b, s * k), e)             # [B,S*k,E]
    rank = ((onehot.cumsum(1) - 1) * onehot).sum(-1)           # in its group
    kept = (rank < capacity(m, s)).reshape(b, s, k)
    return top_e, top_w, kept


def experts(mm, m, p, x):
    """The MoE layer on x [B,S,d]."""
    b, s, d = x.shape
    k = m["n_experts_per_tok"]
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    top_e, top_w, kept = route(m, probs)
    flat = x.reshape(b * s, d)
    out = x.new_zeros(b * s * k, d)
    tok = torch.arange(b * s, device=x.device).repeat_interleave(k)
    sel_e, sel_k = top_e.reshape(-1), kept.reshape(-1)
    for e in range(m["n_experts"]):
        idx = torch.nonzero((sel_e == e) & sel_k).flatten()
        if idx.numel():
            out = out.index_put(
                (idx,), swiglu(mm, flat[tok[idx]], p["wi"][e], p["wg"][e],
                               p["wo"][e]))
    w = (top_w * kept).reshape(b * s, k, 1)
    return (out.view(b * s, k, d) * w).sum(1).view(b, s, d)


def aux_loss(mm, m, router, x):
    probs = torch.softmax(mm(x, router), dim=-1)
    top_e, _, _ = route(m, probs)
    frac = F.one_hot(top_e, m["n_experts"]).float().mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return m["n_experts"] * torch.sum(frac * imp)


def loss(m: dict, params: dict, batch: dict, mm) -> torch.Tensor:
    """Mean LM loss (with the weighted load-balancing loss) of the MoE
    decoder ``m`` with ``params`` (the program's parameter names, f32)."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed.embed"][tokens.long()]
    eps = m["norm_eps"]
    for i in range(m["n_layers"]):
        pre = f"layers.{i}."
        attn = {n: params[pre + "attn." + n] for n in ("wq", "wk", "wv", "wo")}
        ffn = {n: params[pre + "ffn." + n]
               for n in ("router", "wi", "wg", "wo")}
        h = rmsnorm(x, params[pre + "ln1.scale"], eps)
        x = x + attention(mm, h, attn, n_heads=m["n_heads"],
                          n_kv=m["n_kv_heads"], head_dim=m["head_dim"],
                          theta=m["rope_theta"], window=m["sliding_window"])
        h = rmsnorm(x, params[pre + "ln2.scale"], eps)
        x = x + experts(mm, m, ffn, h)
    x = rmsnorm(x, params["ln_f.scale"], eps)
    out = lm_loss(mm, x, params["embed.unembed"], labels)
    return out + m["aux_loss_weight"] * aux_loss(
        mm, m, params["layers.0.ffn.router"], x)
