"""Prefill and decode step functions (port of
``repro/launch/step_fns.py:39-54``; the train step comes with the training
slice). The port's model owns its weights, so the ``params`` a step takes
is the model itself — the signature stays the JAX one."""
from __future__ import annotations

from repro_torch.configs.base import RunConfig
from repro_torch.models import api as model_api


def make_model(run: RunConfig, device=None):
    return model_api.build_model(run.model, device=device)


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
