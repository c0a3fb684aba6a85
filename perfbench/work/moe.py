"""The work of one train step of the MoE decoder, counted from the
configuration's shapes (never from the program): model FLOPs and the
hand-written kernels' launches, each with the arguments that
``work/cost.py`` charges.

Model FLOPs: 6 x the matmul parameters a token is multiplied by x the
tokens (forward 2, backward 4): attention's four projections, the router
(twice: its layer and the load-balancing loss on the first layer's
router), the top-k experts' three matrices with no capacity padding, the
LM head; plus the causal attention, forward and backward, as
``work/cost.py`` counts it."""
from __future__ import annotations

import torch

from perfbench.work import cost

BF16 = torch.bfloat16


def matmul_params_per_token(m) -> int:
    d, dh = m["d_model"], m["head_dim"]
    attn = d * m["n_heads"] * dh + 2 * d * m["n_kv_heads"] * dh \
        + m["n_heads"] * dh * d
    router = d * m["n_experts"]
    experts = m["n_experts_per_tok"] * 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + router + experts) + router \
        + d * m["vocab_size"]


def launches(m, tr):
    """[(kernel, cost function, arguments, launches a slice step)]."""
    b, s, d = tr["batch"], tr["seq"], m["d_model"]
    layers = m["n_layers"]
    att = (b, m["n_heads"], m["n_kv_heads"], s, s, m["head_dim"], BF16,
           True, m["sliding_window"])
    out = []
    for kern, suffix in (("K1", ""), ("K1_bwd", "_bwd")):
        out.append((kern, "rmsnorm" + suffix, ((b, s, d), BF16), 1))
        out.append((kern, "add_rmsnorm" + suffix, ((b, s, d), BF16),
                    2 * layers))
    out.append(("K2", "attention", att, layers))
    out.append(("K2_bwd", "attention_bwd", att, layers))
    return out


def step_flops(m, tr) -> int:
    """Model FLOPs of one slice's train step."""
    tokens = tr["batch"] * tr["seq"]
    flops = 6 * matmul_params_per_token(m) * tokens
    for _, fn, args, count in launches(m, tr):
        if fn in ("attention", "attention_bwd"):
            flops += count * getattr(cost, fn)(*args).flops
    return flops
