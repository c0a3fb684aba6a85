"""Carry JAX-package weights into the port's model.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (what
``jax.device_get`` returns) and gives the port's state dict: each stacked
tree is split along its leading axes into per-block tensors, the indices
after the stacked name (``layers/wq[3]`` -> ``layers.3.wq``; the hybrid's
``mamba/in_x[g, j]`` -> ``mamba.g.j.in_x`` and ``mamba_tail/a_log[i]`` ->
``mamba_tail.i.a_log``), and every dtype is kept (the hybrid's f32
``a_log``, ``d_skip`` and ``dt_bias`` stay f32 in a bf16 model). numpy
has no bfloat16 of its own, so bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays or as their ``uint16`` bit views (the trick ``repro/checkpoint/io.py``
uses); both become ``torch.bfloat16`` bit for bit.
Nothing here imports jax.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, name + ".")
        else:
            yield name, np.asarray(val)


def to_tensor(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> torch, with bf16 (ml_dtypes or a uint16 view) kept bitwise."""
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _stacked(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Stacked tree name -> its leading axes, for ``cfg``'s family."""
    if cfg.family == "hybrid":
        out = {"mamba": (cfg.n_layers // cfg.attn_every, cfg.attn_every)}
        if cfg.n_layers % cfg.attn_every:
            out["mamba_tail"] = (cfg.n_layers % cfg.attn_every,)
        return out
    return {"layers": (cfg.n_layers,)}


def params_from_jax(tree: dict, cfg: ModelConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of the dense transformer or the hybrid ->
    the port's state dict, for the model's ``load_state_dict``."""
    stacked = _stacked(cfg)
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, arr in _leaves(tree):
        head, _, rest = name.partition(".")
        lead = stacked.get(head)
        if lead is None:
            out[name] = to_tensor(arr, device)
            continue
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"{name}: leading axes {arr.shape[:len(lead)]} "
                             f"are not {lead}")
        for idx in np.ndindex(*lead):
            key = ".".join([head, *map(str, idx), rest])
            out[key] = to_tensor(arr[idx], device)
    return out
