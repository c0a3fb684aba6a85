"""Decoder-only transformer: the dense, MoE and VLM families (port of
``repro/models/transformer.py:29-268``, serving and the dense and VLM
loss).

The JAX model stacks its layers on a leading ``L`` axis and scans over
them; here each layer is one module of an ``nn.ModuleList`` and the forward
loops over them in Python. Parameter names mirror the JAX tree, with the
layer index after ``layers`` (``layers.3.attn.wq`` <-> ``layers/attn/wq[3]``),
so ``models.convert`` carries JAX weights across by name. The KV cache is a
list of per-layer dicts instead of one dict of stacked arrays.

A layer's ``ffn`` is the MoE (``models.moe``) when ``cfg.n_experts`` is
set, the SwiGLU MLP otherwise, as the reference's ``_ffn_params`` /
``_ffn_apply`` choose.

VLM (llama-3.2-vision): ``n_layers = G * cross_attn_every``; each group is
one gated cross-attention layer over the image memory followed by
``cross_attn_every`` self-attention layers (``layers.<g>.<k>....`` <->
``layers/...[g, k]``, ``cross.<g>....`` <-> ``cross/...[g]``). The cache
is ``{"self": [G lists of k layer caches], "cross": [G dicts of the
memory's k and v]}``; the memory's K/V are made at prefill and only read
by decode.

Training differentiates ``loss_fn(cfg, params, batch)``: the weights it
takes are the train state's (a flat dict under the state-dict names), not
the module's, and it runs the same layer functions as ``prefill``. The
module's own parameters never need grads; ``prefill`` and ``decode_step``
run under ``no_grad``. Every family here trains; the MoE's loss adds
the reference's load-balancing term (``moe.moe_aux_loss``).

The residual stream is carried as (x, r): r is the last branch output not
yet added, and the next norm adds it (``layers.add_rmsnorm``, one launch on
the card). The sums and their order are the JAX model's: x + attention,
then x + FFN, each rounded to the model dtype before its norm. The cross
layer has no pre-norm and reads the stream itself, so the pending r is
added into x before it (the same model-dtype add), and its gated output
becomes the r that the next ``ln1`` fuses.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

FAMILIES = ("dense", "moe", "vlm")
_ZERO_INIT = ("bq", "bk", "bv", "bo", "gate")


class ParamTree(nn.Module):
    """A nested dict of tensors held as a module: ``p["wq"]`` and
    ``p["q_norm"]["scale"]`` read like the JAX param dicts, and the
    state-dict names follow the same paths. Weights never need grads here,
    so every parameter is made with ``requires_grad=False``."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _ffn_params(cfg: ModelConfig, dtype, dev) -> dict:
    if cfg.n_experts:
        return MOE.moe_params(cfg, dtype, dev)
    return L.mlp_params(cfg.d_model, cfg.d_ff, dtype, dev)


def _ffn_apply(cfg: ModelConfig, p, x):
    if cfg.n_experts:
        return MOE.moe_apply(cfg, p, x)
    return L.mlp_apply(p, x)


def _layer_params(cfg: ModelConfig, dtype, dev) -> dict:
    return {
        "ln1": L.rmsnorm_params(cfg.d_model, dtype, dev),
        "attn": L.attention_params(cfg, dtype, dev),
        "ln2": L.rmsnorm_params(cfg.d_model, dtype, dev),
        "ffn": _ffn_params(cfg, dtype, dev),
    }


def _layer_apply(cfg: ModelConfig, lp, x, r, positions, *, cache=None):
    """One decode layer on the stream (x, r). Returns (x, r, new_cache),
    r being this layer's FFN output."""
    x, h = L.add_rmsnorm(lp["ln1"], x, r, cfg.norm_eps)
    h, new_cache = L.attention_apply(cfg, lp["attn"], h, positions,
                                     cache=cache)
    x, h = L.add_rmsnorm(lp["ln2"], x, h, cfg.norm_eps)
    return x, _ffn_apply(cfg, lp["ffn"], h), new_cache


def _prefill_layer(cfg: ModelConfig, lp, x, r, positions):
    """One prompt layer on the stream (x, r): (x, r, the layer's cache)."""
    x, h = L.add_rmsnorm(lp["ln1"], x, r, cfg.norm_eps)
    q, k, v = L._project_qkv(cfg, lp["attn"], h, positions, cfg.rope_theta)
    out = L.prefill_attention(q, k, v, window=cfg.sliding_window)
    x, h = L.add_rmsnorm(lp["ln2"], x, L.attention_out(lp["attn"], out),
                         cfg.norm_eps)
    return (x, _ffn_apply(cfg, lp["ffn"], h),
            L.init_cache_from(cfg, k, v, positions, cfg.sliding_window))


def _cross_apply(cfg: ModelConfig, cp, x, r, kv):
    """The cross layer on the stream (x, r): the pending r added into x
    first (the layer reads the stream), its gated output the new r."""
    if r is not None:
        x = x + r
    return x, L.cross_attention_apply(cfg, cp, x, kv=kv)


class Transformer(nn.Module):
    """Dense, MoE or VLM decoder: ``init`` / ``init_cache`` / ``prefill`` /
    ``decode_step``. Built on ``device`` (CUDA unless told otherwise) with
    uninitialised weights; ``init(generator)`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"Transformer covers the families {FAMILIES}, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        dev = device_lib.resolve(device)
        self.embed = ParamTree(L.embed_params(cfg, self.dtype, dev))
        self.ln_f = ParamTree(L.rmsnorm_params(cfg.d_model, self.dtype, dev))

        def layer():
            return ParamTree(_layer_params(cfg, self.dtype, dev))
        if cfg.family == "vlm":
            if cfg.n_layers % cfg.cross_attn_every:
                raise ValueError(f"n_layers {cfg.n_layers} is not a whole "
                                 f"number of groups of "
                                 f"{cfg.cross_attn_every}")
            self.n_groups = cfg.n_layers // cfg.cross_attn_every
            self.layers = nn.ModuleList(
                nn.ModuleList(layer() for _ in range(cfg.cross_attn_every))
                for _ in range(self.n_groups))
            self.cross = nn.ModuleList(
                ParamTree(L.cross_attention_params(cfg, self.dtype, dev))
                for _ in range(self.n_groups))
        else:
            self.layers = nn.ModuleList(layer() for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.ln_f["scale"].device

    # -- params ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Transformer":
        """Norm scales 1, biases 0, every matrix normal * fan_in^-1/2 —
        the JAX init's distribution (not its bits). ``gen`` must live on
        the model's device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1)
            elif leaf in _ZERO_INIT:
                p.zero_()
            else:
                L.dense_init_(p, gen)
        return self

    # -- serve ----------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        w = self.cfg.sliding_window
        return min(seq_len, w) if w else seq_len

    def init_cache(self, batch: int, seq_len: int):
        cfg, dev = self.cfg, self.device
        cl = self.cache_len(seq_len)
        if cfg.family == "vlm":
            mem = (batch, cfg.n_image_tokens, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
            return {"self": [[L.empty_cache(cfg, batch, cl, self.dtype, dev)
                              for _ in group] for group in self.layers],
                    "cross": [{"k": torch.zeros(mem, dtype=self.dtype,
                                                device=dev),
                               "v": torch.zeros(mem, dtype=self.dtype,
                                                device=dev)}
                              for _ in self.cross]}
        return [L.empty_cache(cfg, batch, cl, self.dtype, dev)
                for _ in self.layers]

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Process the full prompt (and, for the VLM, ``image_embeds``
        [B, M, d]); return (last_logits [B, 1, V], cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        x, r = L.embed_lookup(self.embed, tokens), None
        if cfg.family == "vlm":
            cache = {"self": [], "cross": []}
            for group, cp in zip(self.layers, self.cross):
                kv = L.cross_attention_kv(cfg, cp, batch["image_embeds"])
                x, r = _cross_apply(cfg, cp, x, r, kv)
                caches = []
                for lp in group:
                    x, r, c = _prefill_layer(cfg, lp, x, r, positions)
                    caches.append(c)
                cache["self"].append(caches)
                cache["cross"].append({"k": kv[0], "v": kv[1]})
        else:
            cache = []
            for lp in self.layers:
                x, r, c = _prefill_layer(cfg, lp, x, r, positions)
                cache.append(c)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        logits = L.unembed(cfg, self.embed, x[:, -1:, :])
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """tokens: [B, 1]; pos: [B, 1] absolute positions. Writes each
        layer's ring cache in place (see ``layers.attention_apply``); the
        VLM's cross K/V pass through unchanged."""
        cfg = self.cfg
        x, r = L.embed_lookup(self.embed, tokens), None
        if cfg.family == "vlm":
            new_cache = {"self": [], "cross": cache["cross"]}
            for group, cp, ckv, sc in zip(self.layers, self.cross,
                                          cache["cross"], cache["self"]):
                x, r = _cross_apply(cfg, cp, x, r, (ckv["k"], ckv["v"]))
                new_sc = []
                for lp, ci in zip(group, sc):
                    x, r, nc = _layer_apply(cfg, lp, x, r, pos, cache=ci)
                    new_sc.append(nc)
                new_cache["self"].append(new_sc)
        else:
            new_cache = []
            for lp, ci in zip(self.layers, cache):
                x, r, nc = _layer_apply(cfg, lp, x, r, pos, cache=ci)
                new_cache.append(nc)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        logits = L.unembed(cfg, self.embed, x)
        return logits, new_cache


# -- train ------------------------------------------------------------------

def nest(params: Dict[str, torch.Tensor]) -> dict:
    """A flat dict under state-dict names (``layers.3.attn.wq``) as the
    nested dict the layer functions read (``p["layers"]["3"]["attn"]``);
    the tensors themselves, no copies."""
    out: dict = {}
    for name, t in params.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: dict,
            seq_chunk: int = 2048) -> torch.Tensor:
    """The f32 mean LM loss of ``params`` (state-dict names) on ``batch``
    (``tokens``, ``labels``: [B, S] integer tensors on the params' device;
    for the VLM also ``image_embeds`` [B, M, d]): the reference's
    ``loss_fn`` (``transformer.py:110-152``) for the dense, MoE and VLM
    families, through the same residual stream (x, r) and fused norms as
    ``prefill``, differentiable. A VLM group is the reference's: the
    memory's K/V, the gated cross output added to the stream, then the
    group's self layers. MoE adds 0.01 times the aux loss of the first
    layer's router on the normed backbone output, as the reference does
    (``transformer.py:148-151``)."""
    check_trainable(cfg)
    p = nest(params)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x, r = L.embed_lookup(p["embed"], tokens), None
    if cfg.family == "vlm":
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            cp = p["cross"][str(g)]
            kv = L.cross_attention_kv(cfg, cp, batch["image_embeds"])
            x, r = _cross_apply(cfg, cp, x, r, kv)
            for k in range(cfg.cross_attn_every):
                x, r, _ = _layer_apply(cfg, p["layers"][str(g)][str(k)], x,
                                       r, positions)
    else:
        for i in range(cfg.n_layers):
            x, r, _ = _layer_apply(cfg, p["layers"][str(i)], x, r,
                                   positions)
    _, x = L.add_rmsnorm(p["ln_f"], x, r, cfg.norm_eps)
    loss = L.chunked_lm_loss(cfg, p["embed"], x, labels, seq_chunk)
    if cfg.n_experts:
        loss = loss + 0.01 * MOE.moe_aux_loss(cfg, p["layers"]["0"]["ffn"],
                                              x)
    return loss


TRAINABLE = ("dense", "moe", "vlm", "hybrid", "audio", "ssm")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port trains ``cfg``'s
    family (every family of the reference: ``TRAINABLE``)."""
    if cfg.family not in TRAINABLE:
        raise NotImplementedError(f"training the {cfg.family!r} family is "
                                  f"not ported")
