"""AdamW for the port's train state (port of ``repro/optim/adamw.py``).

bf16 params, f32 moments, decoupled weight decay, linear warmup then a
cosine decay, with the reference's order of operations (``adamw.py:58-71``)
and its f32 schedule and bias corrections (computed on the host in numpy
f32 from the step count, the same each run).

The update is in place: params, m and v are written where they are. That
is the counterpart of the reference's donation (``jax.jit(step_fn,
donate_argnums=(0, 1))``, ``launch/train.py:45``). A functional update
would hold the old and the new state at once: about 40 bytes a parameter
while a replica steps beside the computational slice, against about 22 in
place. It is safe under the FT layer because the replica's state is a
``copy_tree`` clone and every snapshot is a copy. Large leaves are updated
in flat chunks of ``CHUNK`` elements, so no leaf-sized f32 temporary is
made (the embedding and unembedding of qwen3-8b are 622 M elements each).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch

F32 = torch.float32
CHUNK = 1 << 24                     # elements a temporary holds at most


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero f32 moments beside each parameter, step 0 on the params'
    device."""
    dev = next(iter(params.values())).device if params else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=F32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=F32, device=p.device)
           for k, p in params.items()})


def schedule(cfg: AdamWConfig, step) -> np.float32:
    """The learning rate at ``step`` (a number or an f32 array), in f32 as
    the reference computes it: ``lr * warm * cos``."""
    f = np.float32
    s = np.asarray(step, dtype=f)
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f((1 - cfg.min_lr_frac) * 0.5) * (
        f(1.0) + np.cos(f(math.pi) * prog))
    return f(cfg.lr) * warm * cos


def _chunks(n: int):
    for lo in range(0, n, CHUNK):
        yield slice(lo, min(n, lo + CHUNK))


@torch.no_grad()
def _update_leaf(p, g, m, v, *, b1, b2, bc1, bc2, lr, eps, wd):
    pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
    for sl in _chunks(pf.numel()):
        g32 = gf[sl].to(F32)
        mc, vc = mf[sl], vf[sl]
        t = g32.mul(1 - b1)
        mc.mul_(b1).add_(t)                          # b1 m + (1 - b1) g
        t.copy_(g32).mul_(1 - b2).mul_(g32)          # (1 - b2) g g
        del g32
        vc.mul_(b2).add_(t)                          # b2 v + ...
        del t
        den = vc.div(bc2).sqrt_().add_(eps)          # sqrt(v / bc2) + eps
        delta = mc.div(bc1).div_(den)                # (m / bc1) / den
        del den
        p32 = pf[sl].to(F32)
        delta.add_(p32.mul(wd))                      # + wd p
        pf[sl].copy_(p32.sub_(delta.mul_(lr)))       # p - lr delta


def update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor],
           state: AdamWState, params: Dict[str, torch.Tensor]) -> AdamWState:
    """One AdamW step, in place: each param and both moments are written
    where they are; returns the state with the new step count. The lr and
    the bias corrections are f32 scalars from the host."""
    step = int(state.step) + 1
    f = np.float32
    lr = float(schedule(cfg, step))
    bc1 = float(f(1) - np.power(f(cfg.beta1), f(step)))
    bc2 = float(f(1) - np.power(f(cfg.beta2), f(step)))
    for k, p in params.items():
        _update_leaf(p, grads[k], state.m[k], state.v[k], b1=cfg.beta1,
                     b2=cfg.beta2, bc1=bc1, bc2=bc2, lr=lr, eps=cfg.eps,
                     wd=cfg.weight_decay)
    with torch.no_grad():
        state.step.add_(1)
    return state
