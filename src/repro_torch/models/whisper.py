"""Whisper-style encoder/decoder, the audio family (port of
``repro/models/whisper.py``).

The conv/mel frontend is a stub, as in the reference: the model consumes
frame embeddings ``frames[B, n_frames, d_model]`` (what the conv stack
would emit). Encoder layers are bidirectional self-attention (K2
non-causal on the card, Sq = Skv = n_frames); decoder layers are causal
self-attention, the ungated cross-attention into the encoder output (K2
non-causal at Sq != Skv for the prompt, plain for a decode token) and a
GELU MLP. RMSNorm replaces the published biased LayerNorm, and RoPE the
sinusoidal positions; the reference's docstring puts RoPE on the decoder,
but its ``encode`` rotates the encoder's q and k too (``whisper.py:98``),
and so does the port.

The reference stacks its layers and scans over them; here each layer is
one module (``enc_layers.3.attn.wq`` <-> ``enc_layers/attn/wq[3]``,
``dec_layers.1.xattn.gate`` <-> ``dec_layers/xattn/gate[1]``), so
``models.convert`` carries JAX weights across by name. Each cross layer
carries the reference's unused ``gate`` (whisper's layers are ungated); its
gradient is zero.

The cache is ``{"self": [a ring KV cache a decoder layer], "cross": {"k",
"v"}}``, the cross K/V [n_layers, B, n_frames, Hkv, Dh] made once at
prefill and only read by decode.

The residual stream is carried as (x, r), r being the last branch output
not yet added, and each norm after an add fuses it
(``layers.add_rmsnorm``): the reference's sums in its order, each rounded
to the model dtype before its norm. Training differentiates
``loss_fn(cfg, params, batch)`` over the train state's params (a flat dict
under the state-dict names, nested by ``transformer.nest``), through the
same ``encode`` and ``_dec_layer`` as serving.

One deliberate difference, F6: the reference's attention rounds the
softmax weights to bf16 before the PV product even in f32
(``layers.py:108``); the port keeps them in f32, as K2 and
``kernels/ref.py`` do.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import ParamTree, nest

F32 = torch.float32


def _gelu_mlp_params(d: int, f: int, dtype, dev) -> dict:
    return {"wi": torch.empty((d, f), dtype=dtype, device=dev),
            "wo": torch.empty((f, d), dtype=dtype, device=dev)}


def _gelu_mlp(p, x):
    """GELU MLP: ``jax.nn.gelu``'s default tanh form, in f32."""
    h = x @ p["wi"]
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return h @ p["wo"]


def _enc_layer_params(cfg: ModelConfig, dtype, dev) -> dict:
    return {"ln1": L.rmsnorm_params(cfg.d_model, dtype, dev),
            "attn": L.attention_params(cfg, dtype, dev),
            "ln2": L.rmsnorm_params(cfg.d_model, dtype, dev),
            "mlp": _gelu_mlp_params(cfg.d_model, cfg.d_ff, dtype, dev)}


def _dec_layer_params(cfg: ModelConfig, dtype, dev) -> dict:
    return {"ln1": L.rmsnorm_params(cfg.d_model, dtype, dev),
            "attn": L.attention_params(cfg, dtype, dev),
            "ln_x": L.rmsnorm_params(cfg.d_model, dtype, dev),
            "xattn": L.cross_attention_params(cfg, dtype, dev),
            "ln2": L.rmsnorm_params(cfg.d_model, dtype, dev),
            "mlp": _gelu_mlp_params(cfg.d_model, cfg.d_ff, dtype, dev)}


def _stack(tree, n: int) -> list:
    """The n per-layer trees of a stacked name: a module list's layers,
    or the ``"0"``, ``"1"``, ... entries of a nested train-state dict."""
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(n)]
    return list(tree)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(cfg: ModelConfig, p, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over ``frames`` [B, M, d] (taken in the model dtype):
    bidirectional, RoPE on q and k, then ``ln_enc``. ``p`` holds
    ``enc_layers`` and ``ln_enc`` (the model, or nested train params)."""
    b, m, _ = frames.shape
    pos = _positions(b, m, frames.device)
    x, r = frames.to(p["ln_enc"]["scale"].dtype), None
    for lp in _stack(p["enc_layers"], cfg.n_encoder_layers):
        x, h = L.add_rmsnorm(lp["ln1"], x, r, cfg.norm_eps)
        q, k, v = L._project_qkv(cfg, lp["attn"], h, pos, cfg.rope_theta)
        out = L.prefill_attention(q, k, v, causal=False)
        x, h = L.add_rmsnorm(lp["ln2"], x, L.attention_out(lp["attn"], out),
                             cfg.norm_eps)
        r = _gelu_mlp(lp["mlp"], h)
    return L.add_rmsnorm(p["ln_enc"], x, r, cfg.norm_eps)[1]


def _dec_layer(cfg: ModelConfig, lp, x, r, positions, memory_kv,
               cache=None):
    """One decoder layer on the stream (x, r): causal self-attention
    (``cache`` as ``layers.attention_apply`` takes it), the ungated
    cross-attention over ``memory_kv`` and the GELU MLP. Returns (x, r,
    new_cache), r being the MLP's output."""
    x, h = L.add_rmsnorm(lp["ln1"], x, r, cfg.norm_eps)
    h, new_cache = L.attention_apply(cfg, lp["attn"], h, positions,
                                     cache=cache, window=0)
    x, h = L.add_rmsnorm(lp["ln_x"], x, h, cfg.norm_eps)
    h = L.cross_attention_apply(cfg, lp["xattn"], h, kv=memory_kv,
                                gated=False)
    x, h = L.add_rmsnorm(lp["ln2"], x, h, cfg.norm_eps)
    return x, _gelu_mlp(lp["mlp"], h), new_cache


class Whisper(nn.Module):
    """Encoder/decoder: ``init`` / ``init_cache`` / ``prefill`` /
    ``decode_step``. Built on ``device`` (CUDA unless told otherwise) with
    uninitialised weights; ``init(generator)`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "audio" or not cfg.is_encoder_decoder:
            raise ValueError(f"Whisper is the audio encoder/decoder, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        dev = device_lib.resolve(device)
        d = cfg.d_model
        self.embed = ParamTree(L.embed_params(cfg, self.dtype, dev))
        self.enc_layers = nn.ModuleList(
            ParamTree(_enc_layer_params(cfg, self.dtype, dev))
            for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(
            ParamTree(_dec_layer_params(cfg, self.dtype, dev))
            for _ in range(cfg.n_layers))
        self.ln_enc = ParamTree(L.rmsnorm_params(d, self.dtype, dev))
        self.ln_f = ParamTree(L.rmsnorm_params(d, self.dtype, dev))

    def __getitem__(self, key: str):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.ln_f["scale"].device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Whisper":
        """Norm scales 1, the cross gates 0, every matrix normal *
        fan_in^-1/2 — the JAX init's distribution (not its bits). ``gen``
        must live on the model's device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1)
            elif leaf == "gate":
                p.zero_()
            else:
                L.dense_init_(p, gen)
        return self

    # -- serve ----------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        mem = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads,
               cfg.resolved_head_dim)
        return {"self": [L.empty_cache(cfg, batch, seq_len, self.dtype, dev)
                         for _ in self.dec_layers],
                "cross": {"k": torch.zeros(mem, dtype=self.dtype, device=dev),
                          "v": torch.zeros(mem, dtype=self.dtype,
                                           device=dev)}}

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Encode ``frames`` and process the prompt ``tokens``; return
        (last_logits [B, 1, V], cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        memory = encode(cfg, self, batch["frames"])
        pos = _positions(b, s, tokens.device)
        x, r = L.embed_lookup(self.embed, tokens), None
        rings, ks, vs = [], [], []
        for lp in self.dec_layers:
            kv = L.cross_attention_kv(cfg, lp["xattn"], memory)
            x, h = L.add_rmsnorm(lp["ln1"], x, r, cfg.norm_eps)
            q, k, v = L._project_qkv(cfg, lp["attn"], h, pos, cfg.rope_theta)
            out = L.prefill_attention(q, k, v, window=0)
            x, h = L.add_rmsnorm(lp["ln_x"], x,
                                 L.attention_out(lp["attn"], out),
                                 cfg.norm_eps)
            h = L.cross_attention_apply(cfg, lp["xattn"], h, kv=kv,
                                        gated=False)
            x, h = L.add_rmsnorm(lp["ln2"], x, h, cfg.norm_eps)
            r = _gelu_mlp(lp["mlp"], h)
            rings.append(L.init_cache_from(cfg, k, v, pos, 0))
            ks.append(kv[0])
            vs.append(kv[1])
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        logits = L.unembed(cfg, self.embed, x[:, -1:, :])
        return logits, {"self": rings, "cross": {"k": torch.stack(ks),
                                                 "v": torch.stack(vs)}}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos):
        """tokens: [B, 1]; pos: [B, 1] absolute positions. Writes each
        layer's ring in place (``layers.attention_apply``); the cross K/V
        pass through unchanged."""
        cfg = self.cfg
        x, r = L.embed_lookup(self.embed, tokens), None
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        rings = []
        for i, (lp, ring) in enumerate(zip(self.dec_layers, cache["self"])):
            x, r, ring = _dec_layer(cfg, lp, x, r, pos, (ck[i], cv[i]),
                                    cache=ring)
            rings.append(ring)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        logits = L.unembed(cfg, self.embed, x)
        return logits, {"self": rings, "cross": cache["cross"]}


# -- train ------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: dict,
            seq_chunk: int = 2048) -> torch.Tensor:
    """The f32 mean LM loss of ``params`` (state-dict names) on ``batch``
    (``tokens``, ``labels`` [B, S] and ``frames`` [B, n_frames, d] on the
    params' device): the reference's ``Whisper.loss_fn``
    (``whisper.py:118-134``), differentiable."""
    p = nest(params)
    tokens, labels = batch["tokens"], batch["labels"]
    memory = encode(cfg, p, batch["frames"])
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    x, r = L.embed_lookup(p["embed"], tokens), None
    for lp in _stack(p["dec_layers"], cfg.n_layers):
        kv = L.cross_attention_kv(cfg, lp["xattn"], memory)
        x, r, _ = _dec_layer(cfg, lp, x, r, pos, kv)
    _, x = L.add_rmsnorm(p["ln_f"], x, r, cfg.norm_eps)
    return L.chunked_lm_loss(cfg, p["embed"], x, labels, seq_chunk)
