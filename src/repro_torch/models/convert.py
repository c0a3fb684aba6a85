"""Carry JAX-package weights into the port's model.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (what
``jax.device_get`` returns) and gives the port's state dict: the stacked
leading ``L`` axis of ``layers`` is split into per-layer tensors and every
dtype is kept. numpy has no bfloat16 of its own, so bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays or as their ``uint16`` bit views (the trick
``repro/checkpoint/io.py`` uses); both become ``torch.bfloat16`` bit for bit.
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


def params_from_jax(tree: dict, cfg: ModelConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """JAX dense-transformer params (numpy leaves) -> the port's state
    dict, for ``Transformer.load_state_dict``."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, arr in _leaves(tree):
        if name.startswith("layers."):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} is "
                                 f"not n_layers={cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = to_tensor(arr[i], device)
        else:
            out[name] = to_tensor(arr, device)
    return out
