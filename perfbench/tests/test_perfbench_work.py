"""The benchmark's own work counts: the model FLOPs of a tiny
configuration against hand-worked numbers, the kernels' launches a step,
and the frozen copy of the kernel cost model against the values the
port's ``kernels/cost.py`` gave when it was copied."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests import tiny
from perfbench.work import cost, moe

B, F = torch.bfloat16, torch.float32
TRAFFIC = {"batch": 2, "seq": 32}


def test_moe_flops_by_hand():
    # attention 3 x 4,096 + 4,096 (wk and wv: 2 x 64 x 32), the router
    # 256 twice (its layer and the load-balancing loss), two experts of
    # 3 x 64 x 128, the head 16,384
    assert moe.matmul_params_per_token(tiny.MOE) == 78_336
    assert moe.step_flops(tiny.MOE, TRAFFIC) == \
        6 * 78_336 * 64 + 270_336 + 675_840


def test_moe_flops_at_the_cell():
    # Mixtral's layer a token: attention 2 x 4096 x 4096 + 2 x 4096 x 1024,
    # the router twice 2 x 32,768, two experts of 3 x 4096 x 14336, the
    # head 4096 x 32000: 525,402,112 (the embedding is a gather)
    m = {"d_model": 4096, "head_dim": 128, "n_heads": 32, "n_kv_heads": 8,
         "n_experts": 8, "n_experts_per_tok": 2, "d_ff": 14336,
         "n_layers": 1, "vocab_size": 32000, "sliding_window": 4096}
    assert moe.matmul_params_per_token(m) == 525_402_112
    att = cost.attention(1, 32, 8, 4096, 4096, 128, B, True, 4096).flops
    bwd = cost.attention_bwd(1, 32, 8, 4096, 4096, 128, B, True, 4096).flops
    assert (att, bwd) == (137_472_507_904, 343_681_269_760)
    assert moe.step_flops(m, {"batch": 1, "seq": 4096}) == \
        6 * 525_402_112 * 4096 + att + bwd


def test_launches_a_step():
    m = {(k, fn): n for k, fn, _, n in moe.launches(tiny.MOE, TRAFFIC)}
    assert m[("K1", "rmsnorm")] == 1 and m[("K1", "add_rmsnorm")] == 2
    assert m[("K2_bwd", "attention_bwd")] == 1
    assert not any(k.startswith("K3") for k, _ in m)


FROZEN = [
    ("rmsnorm", ((1, 4096, 7168), B), 117454848, 117440512,
     0.03506114865671642),
    ("add_rmsnorm", ((4, 512, 3584), B), 58727424, 36700160,
     0.01753057432835821),
    ("rmsnorm_bwd", ((1, 4096, 3584), B), 88094720, 102760448,
     0.02629693134328358),
    ("add_rmsnorm_bwd", ((1, 4096, 4096), B), 134234112, 134217728,
     0.040069884179104474),
    ("attention", (1, 32, 32, 4096, 4096, 112, B, True, 0), 117440512,
     120288444416, 0.12162633409100101),
    ("attention_bwd", (4, 32, 32, 512, 512, 112, B, True, 0), 117440512,
     18827182080, 0.035056869253731346),
    ("attention", (1, 32, 8, 4096, 4096, 128, B, True, 4096), 83886080,
     137472507904, 0.13900152467542973),
    ("attention_bwd", (1, 32, 8, 4096, 4096, 128, B, True, 4096), 167772160,
     343681269760, 0.3475038116885743),
    ("mamba_scan", (1, 4096, 112, 64, 64, 128, B, F), 182714368,
     15091105792, 0.054541602388059704),
    ("mamba_scan_bwd", (4, 512, 112, 64, 64, 128, B, F), 122159104,
     18863882240, 0.036465404179104474),
]


@pytest.mark.parametrize("name,args,n_bytes,flops,bound_ms", FROZEN,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(FROZEN)])
def test_frozen_cost_model(name, args, n_bytes, flops, bound_ms):
    work = getattr(cost, name)(*args)
    assert (work.bytes, work.flops) == (n_bytes, flops)
    assert cost.bound(work)["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)
