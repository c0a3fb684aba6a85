"""Carry JAX-package weights into the port's model.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (what
``jax.device_get`` returns) and gives the port's state dict: each stacked
tree is split along its leading axes into per-block tensors, the indices
after the stacked name (``layers/wq[3]`` -> ``layers.3.wq``, an MoE
layer's experts ``layers/ffn/wi[3]`` [E, d, f] -> ``layers.3.ffn.wi``;
the VLM's ``layers/attn/wq[g, j]`` -> ``layers.g.j.attn.wq`` and
``cross/gate[g]`` -> ``cross.g.gate``; the hybrid's
``mamba/in_x[g, j]`` -> ``mamba.g.j.in_x`` and ``mamba_tail/a_log[i]`` ->
``mamba_tail.i.a_log``; whisper's ``enc_layers/attn/wq[i]`` ->
``enc_layers.i.attn.wq`` and ``dec_layers/xattn/gate[i]`` ->
``dec_layers.i.xattn.gate``; xlstm's ``mlstm/w_up[g, j]`` ->
``mlstm.g.j.w_up`` and ``slstm/r_gates[g]`` -> ``slstm.g.r_gates``), and
every dtype is kept (the hybrid's f32 ``a_log``, ``d_skip`` and
``dt_bias`` stay f32 in a bf16 model). numpy
has no bfloat16 of its own, so bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays or as their ``uint16`` bit views (the trick ``repro/checkpoint/io.py``
uses); both become ``torch.bfloat16`` bit for bit.

``params_to_jax`` is the inverse: the port's per-block tensors stacked back
into the reference's tree (``layers.3.attn.wq`` -> ``layers/attn/wq[3]``),
bf16 as its ``uint16`` bits. ``stack_plan`` is the name mapping both use
and ``checkpoint.Checkpointer`` writes the reference's keys with.
Nothing here imports jax.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Tuple

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
    """numpy -> torch, with bf16 (ml_dtypes or a uint16 view) kept bitwise
    and the shape kept (a 0-d leaf such as the VLM's ``gate`` stays 0-d)."""
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        bits = np.ascontiguousarray(arr).view(np.int16).reshape(arr.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    flat = np.ascontiguousarray(arr).reshape(arr.shape)
    return torch.from_numpy(flat.copy()).to(device)


def _stacked(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Stacked tree name -> its leading axes, for ``cfg``'s family."""
    if cfg.family == "hybrid":
        out = {"mamba": (cfg.n_layers // cfg.attn_every, cfg.attn_every)}
        if cfg.n_layers % cfg.attn_every:
            out["mamba_tail"] = (cfg.n_layers % cfg.attn_every,)
        return out
    if cfg.family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_every
        return {"layers": (groups, cfg.cross_attn_every), "cross": (groups,)}
    if cfg.family == "audio":
        return {"enc_layers": (cfg.n_encoder_layers,),
                "dec_layers": (cfg.n_layers,)}
    if cfg.family == "ssm":
        groups = cfg.n_layers // cfg.slstm_every
        return {"mlstm": (groups, cfg.slstm_every - 1), "slstm": (groups,)}
    return {"layers": (cfg.n_layers,)}


def params_from_jax(tree: dict, cfg: ModelConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of any family's model -> the port's
    state dict, for the model's ``load_state_dict``."""
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


def _split_name(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A state-dict name as (the reference's path, the stack index): the
    first run of integer segments is the index (``layers.3.attn.wq`` ->
    (("layers", "attn", "wq"), (3,)); ``mamba.1.4.in_x`` -> (("mamba",
    "in_x"), (1, 4)); ``ln_f.scale`` -> (("ln_f", "scale"), ()))."""
    parts = name.split(".")
    i = next((j for j, p in enumerate(parts) if p.isdigit()), len(parts))
    k = i
    while k < len(parts) and parts[k].isdigit():
        k += 1
    return tuple(parts[:i] + parts[k:]), tuple(int(p) for p in parts[i:k])


def stack_plan(names) -> Dict[Tuple[str, ...],
                              List[Tuple[Tuple[int, ...], str]]]:
    """The reference's path of each stacked (or plain) leaf -> the
    state-dict names stacked into it with their indices, in index order.
    Raises unless each stack is a full grid of indices."""
    plan: Dict[Tuple[str, ...], List[Tuple[Tuple[int, ...], str]]] = {}
    for name in names:
        path, idx = _split_name(name)
        plan.setdefault(path, []).append((idx, name))
    for path, members in plan.items():
        members.sort()
        lead = tuple(max(ix[a] for ix, _ in members) + 1
                     for a in range(len(members[0][0])))
        if [ix for ix, _ in members] != list(np.ndindex(*lead)):
            raise ValueError(f"{'/'.join(path)}: the indices "
                             f"{[ix for ix, _ in members]} are not a full "
                             f"{lead} grid")
    return plan


def stack_shape(members, sd: Mapping[str, torch.Tensor]) -> Tuple[int, ...]:
    """The stacked leaf's shape: the index grid, then the block's shape."""
    lead = tuple(i + 1 for i in members[-1][0])
    return lead + tuple(sd[members[0][1]].shape)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One host copy of ``t``: bf16 as its uint16 bits."""
    host = t.detach().to("cpu", memory_format=torch.contiguous_format)
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def params_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> the reference's nested tree of numpy
    arrays, per-block tensors stacked on their leading axes (bf16 as
    ``uint16`` bits): the inverse of ``params_from_jax``."""
    out: dict = {}
    for path, members in stack_plan(sd).items():
        if members[0][0]:
            arr = np.stack([to_numpy(sd[name]) for _, name in members])
            arr = arr.reshape(stack_shape(members, sd))
        else:
            arr = to_numpy(sd[members[0][1]])
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out


def train_state_to_jax(state: dict) -> dict:
    """A port train state {"params", "opt": AdamWState(step, m, v)} as the
    reference's: the same nesting with stacked numpy leaves, ``opt`` as
    the tuple (step, m, v)."""
    opt = state["opt"]
    return {"params": params_to_jax(state["params"]),
            "opt": (to_numpy(opt.step), params_to_jax(opt.m),
                    params_to_jax(opt.v))}
