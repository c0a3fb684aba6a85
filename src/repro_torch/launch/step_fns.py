"""Step functions (train / prefill / decode; port of
``repro/launch/step_fns.py``). The serve steps take the model itself as
their ``params`` (it owns its weights); the train step takes the train
state's params, a flat dict under the state-dict names, and updates them
in place."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import api as model_api
from repro_torch.models import transformer, whisper, xlstm, zamba
from repro_torch.optim import adamw

# each trainable family's loss over the train state's params
LOSS_FNS = {"dense": transformer.loss_fn, "vlm": transformer.loss_fn,
            "hybrid": zamba.loss_fn, "audio": whisper.loss_fn,
            "ssm": xlstm.loss_fn}


def make_model(run: RunConfig, device=None):
    return model_api.build_model(run.model, device=device)


def make_opt_cfg(run: RunConfig) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=run.learning_rate,
                             weight_decay=run.weight_decay,
                             beta1=run.beta1, beta2=run.beta2)


def make_train_step(run: RunConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and every parameter's gradient, then one AdamW step
    written into ``params`` and the moments in place (the counterpart of
    the reference's donated jit); the grads are freed before it returns.
    ``batch`` holds ``tokens`` and ``labels`` (and, for audio,
    ``frames``; for the VLM, ``image_embeds``) as tensors on the params'
    device. The loss is the
    family's (``LOSS_FNS``). Returns the step and the model's config (the
    reference returns its model; here the weights live in the state)."""
    cfg = run.model
    transformer.check_trainable(cfg)
    loss_fn = LOSS_FNS[cfg.family]
    opt_cfg = make_opt_cfg(run)
    seq_chunk = run.seq_chunk

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        # leaves that share the state's storage: the graph reads them, and
        # the update below writes the state's tensors once it is freed
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(cfg, leaves, batch, seq_chunk)
        # a leaf the loss never reads (whisper's cross gates) gets a zero
        # gradient, as jax.grad gives it
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
        del leaves
        opt_state = adamw.update(opt_cfg, grads, opt_state, params)
        del grads
        return params, opt_state, loss.detach()

    return train_step, cfg


def make_prefill_step(run: RunConfig, device=None):
    model = make_model(run, device)

    def prefill_step(params, batch):
        return params.prefill(batch)

    return prefill_step, model


def make_decode_step():
    """The decode step of a model ``make_prefill_step`` built (unlike the
    JAX version this builds no second model). It writes the ring cache in
    place — the JAX server donates the cache to its decode jit for the
    same effect."""
    def decode_step(params, cache, tokens, pos):
        return params.decode_step(cache, tokens, pos)

    return decode_step
