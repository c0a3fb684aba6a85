"""Cells at a size the CPU runs in seconds: the real cells' traffic and
limits with the model and batch cut down, in float32 so that the program
and the reference agree to round-off."""
from __future__ import annotations

import copy
from types import SimpleNamespace

from perfbench import bench

MOE = {"arch": "mixtral-8x7b", "family": "moe", "n_layers": 1,
       "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
       "d_ff": 128, "vocab_size": 256, "n_experts": 4, "n_experts_per_tok": 2,
       "capacity_factor": 1.25, "sliding_window": 64, "rope_theta": 1e6,
       "aux_loss_weight": 0.01, "norm_eps": 1e-05, "dtype": "float32"}
MODELS = {"moe": MOE}


def cell(name: str, batch: int = 2, seq: int = 32, **model) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` at the tiny size."""
    real = bench.load_cell(name)
    c = copy.deepcopy(real)
    c.model = {**MODELS[real.model["family"]], **model}
    c.traffic["batch"], c.traffic["seq"] = batch, seq
    return c
