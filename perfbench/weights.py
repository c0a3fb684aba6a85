"""The cell's weights, made by the benchmark from ``--seed`` on the device.

The names, shapes and dtypes are the program's state-dict layout (its
model built on ``meta``); the values are the benchmark's own, so the
program and the plain reference start from the same bits. One buffer a
dtype holds its leaves: the matrices are drawn by a single ``randn`` call
on a ``torch.Generator`` of the device and scaled in one call for each
distinct standard deviation (the leaves are laid out by it), and the norm
scales, biases and Mamba2 constants are filled in a call for each value
(in a bf16 model the f32 leaves are only the Mamba2 decay, skip and step
bias, all constants).

A matrix is normal with std ``scale / sqrt(fan_in)``, fan_in being the
size its product contracts: the leading dims of a weight applied as
``x @ w``, the input width of a stacked expert matrix, the width of an
embedding row.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# leaf name -> the constant it starts at (the program's init constants)
CONST = {"scale": 1.0, "conv_b": 0.0, "a_log": 0.0, "d_skip": 1.0,
         "dt_bias": -2.0}
# leaf name -> factor on the std (a depthwise conv contracts only K taps)
SCALE = {"conv_w": 2.0}
ALIGN = 64                      # elements: every leaf starts 128-byte aligned


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("embed.embed"):
        return shape[-1]
    if len(shape) == 3 and ".ffn." in name:          # [E, in, out] experts
        return shape[1]
    if leaf in ("wq", "wk", "wv"):                   # [d, H, Dh]
        return shape[0]
    return math.prod(shape[:-1])


def layout(cfg) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every parameter, in the program's order."""
    from repro_torch.models import api
    model = api.build_model(cfg, device="meta")
    return [(k, tuple(p.shape), p.dtype) for k, p in model.named_parameters()]


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def draw(spec, seed: int, device):
    """The weights under ``spec`` (``layout``'s list) for ``seed``: (a
    dict name -> tensor in the program's order, the buffers by dtype).
    The tensors are views of one buffer a dtype; each buffer's matrices
    are drawn by one ``randn`` call and scaled in one call a distinct std,
    its constants filled in one call a value."""
    groups: Dict[torch.dtype, tuple] = {}
    for name, shape, dtype in spec:
        dense, consts = groups.setdefault(dtype, ([], []))
        leaf = name.rsplit(".", 1)[-1]
        if leaf in CONST:
            consts.append((CONST[leaf], name, shape))
        else:
            std = SCALE.get(leaf, 1.0) / math.sqrt(fan_in(name, shape))
            dense.append((std, name, shape))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
    views, bufs = {}, {}
    for dtype in sorted(groups, key=str):
        dense, consts = (sorted(g, key=lambda t: t[0]) for g in groups[dtype])
        offs, at, runs = {}, 0, []
        for kind, items in (("randn", dense), ("fill", consts)):
            for val, name, shape in items:
                offs[name] = at
                n = math.prod(shape)
                if runs and runs[-1][0] == kind and runs[-1][1] == val:
                    runs[-1][3] = at + n
                else:
                    runs.append([kind, val, at, at + n])
                at += _aligned(n)
        n_dense = offs[consts[0][1]] if consts else at
        buf = torch.empty(max(at, 1), dtype=dtype, device=device)
        if n_dense:
            torch.randn(n_dense, generator=gen, dtype=dtype, device=device,
                        out=buf[:n_dense])
        with torch.no_grad():
            for kind, val, lo, hi in runs:
                if kind == "randn":
                    buf[lo:hi].mul_(val)
                else:
                    buf[lo:hi].fill_(val)
        for _, name, shape in dense + consts:
            views[name] = buf[offs[name]:offs[name] + math.prod(shape)] \
                .view(shape)
        bufs[str(dtype)] = buf
    return {name: views[name] for name, _, _ in spec}, bufs
