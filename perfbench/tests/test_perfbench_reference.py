"""Each reference family against the port's plain CPU path at a reduced
size, in float32: the same loss and the same gradient of every
parameter, from the benchmark's weights and batches."""
from __future__ import annotations

import pytest
import torch

from perfbench import bench
from perfbench import weights as W
from perfbench.reference import common
from perfbench.tests import tiny

CELLS = ["mixtral-8x7b.train-4k.repl"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port(name):
    from repro_torch.launch.step_fns import LOSS_FNS
    cell = tiny.cell(name)
    cfg = bench.program_config(cell.model)
    params, _ = W.draw(W.layout(cfg), 7, "cpu")
    batch = bench.Feed(7, cell.traffic, cfg.vocab_size, "cpu")(0)
    mine = {k: p.detach().clone().requires_grad_(True)
            for k, p in params.items()}
    theirs = {k: p.detach().clone().requires_grad_(True)
              for k, p in params.items()}
    ref = bench.family_module("reference", cell.model["family"])
    loss_ref = ref.loss(cell.model, mine, batch, common.F32_MM)
    loss_port = LOSS_FNS[cfg.family](cfg, theirs, batch, 16)
    assert float(loss_ref.detach()) == pytest.approx(
        float(loss_port.detach()), abs=2e-6)
    g_ref = torch.autograd.grad(loss_ref, list(mine.values()))
    g_port = torch.autograd.grad(loss_port, list(theirs.values()),
                                 allow_unused=True, materialize_grads=True)
    for k, a, b in zip(mine, g_ref, g_port):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale, k


def test_moe_capacity_drops_in_token_order():
    from perfbench.reference import moe
    m = {"n_experts": 2, "n_experts_per_tok": 1, "capacity_factor": 1.0}
    # 4 tokens all to expert 0: capacity int(4 * 1 / 2) + 1 = 3
    probs = torch.tensor([[[0.9, 0.1]] * 4])
    e, w, kept = moe.route(m, probs)
    assert e.flatten().tolist() == [0, 0, 0, 0]
    assert kept.flatten().tolist() == [True, True, True, False]
    assert torch.allclose(w, torch.ones_like(w))


def test_fp8_product_rounds_both_operands():
    a = torch.tensor([[1.0, 0.3]])
    b = torch.tensor([[1.0], [1.0]])
    exact = common.F32_MM(a, b)
    rounded = common.FP8_MM(a, b)
    assert float(exact) == pytest.approx(1.3)
    assert float(rounded) != float(exact)            # 0.3 is not an e4m3
    assert abs(float(rounded) - 1.3) < 0.02
