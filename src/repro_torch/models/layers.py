"""Shared layers of the decoders, in PyTorch (port of
``repro/models/layers.py``: the dense layers and the cross-attention,
gated for the VLM and ungated for whisper).

Conventions (kept from the JAX package so the two compare like with like)
---------------------------------------------------------------------------
- Params are nested dicts with the JAX names (``ParamTree`` modules in the
  model); ``wq`` is [d, H, Dh], ``wo`` is [H, Dh, d].
- Activations: ``x[batch, seq, d_model]``; attention heads ``[B, S, H, Dh]``.
- Compute dtype is the model's (bf16) with f32 softmax / norm accumulation.
- RMSNorm and prefill attention (the cross-attention's too, non-causal
  over Sq != Skv) go through ``kernels.ops``: the hand-written CUDA
  kernels on the card, their plain versions on the CPU. Decode attention
  is plain PyTorch, as it is plain jnp in the JAX package.

One deliberate difference: the JAX model's blockwise attention casts the
probability tile to bf16 before the PV product (``layers.py:108``); the
port follows the TPU kernel and ``kernels/ref.py`` and keeps it in f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.distributed import parallel
from repro_torch.distributed.context import current_mesh

F32 = torch.float32
NEG_INF = -1e30
CACHE_HEADROOM = 64


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init_(t: torch.Tensor, gen: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """Fill ``t`` in place with normal * scale * fan_in^-1/2 (fan_in =
    leading dim), drawn in f32 — the JAX ``_dense_init`` distribution."""
    fan_in = t.shape[0] if t.dim() >= 1 else 1
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.randn(t.shape, generator=gen, dtype=F32, device=t.device)
    t.copy_(w * std)
    return t


def rmsnorm_params(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def attention_params(cfg: ModelConfig, dtype, device) -> dict:
    """Uninitialised attention weights (``init`` fills them)."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": torch.empty((d, cfg.n_heads, dh), dtype=dtype, device=device),
        "wk": torch.empty((d, cfg.n_kv_heads, dh), dtype=dtype,
                          device=device),
        "wv": torch.empty((d, cfg.n_kv_heads, dh), dtype=dtype,
                          device=device),
        "wo": torch.empty((cfg.n_heads, dh, d), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, dh), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, dh), dtype=dtype,
                              device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_params(dh, dtype, device)
        p["k_norm"] = rmsnorm_params(dh, dtype, device)
    return p


def mlp_params(d: int, f: int, dtype, device) -> dict:
    return {"wi": torch.empty((d, f), dtype=dtype, device=device),
            "wg": torch.empty((d, f), dtype=dtype, device=device),
            "wo": torch.empty((f, d), dtype=dtype, device=device)}


def embed_params(cfg: ModelConfig, dtype, device) -> dict:
    p = {"embed": torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                              device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = torch.empty((cfg.d_model, cfg.vocab_size),
                                   dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RMSNorm, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim; ``p`` holds ``scale`` [d]."""
    return ops.rmsnorm(x, p["scale"], eps=eps)


def add_rmsnorm(p, x: torch.Tensor, r: Optional[torch.Tensor],
                eps: float = 1e-5):
    """The residual add before a norm, fused with it: (x + r, rmsnorm of
    it), the sum rounded to x's dtype as a separate ``x + r`` rounds it.
    ``r`` is the previous branch's output, or None where no branch output
    is pending (the first norm of a forward): then (x, rmsnorm(x))."""
    if r is None:
        return x, rmsnorm(p, x, eps)
    return ops.add_rmsnorm(x, r, p["scale"], eps=eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] absolute token positions."""
    half = x.shape[-1] // 2
    # log(theta) in f32, as jnp.log computes it; everything else is made on
    # x's device (a host tensor copied over would synchronise the stream)
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=F32,
                                                device=x.device) / half)
    ang = positions[..., None].to(F32) * freqs               # [B, S, half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _scores_block(q, k, q_pos, k_pos, window: int, causal: bool = True):
    """q: [B, Tq, Hkv, G, Dh], k: [B, Tk, Hkv, Dh] -> masked f32 scores
    [B, Hkv, G, Tq, Tk]; ``k_pos`` None masks nothing (cross-attention)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(F32), k.to(F32))
    s = s * (1.0 / q.shape[-1] ** 0.5)
    if k_pos is None:
        return s
    mask = (k_pos >= 0)[:, None, :]                        # empty cache slots
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return torch.where(mask[:, None, None, :, :], s, NEG_INF)


def prefill_attention(q, k, v, *, window: int = 0,
                      causal: bool = True) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over one prompt whose
    positions run from 0, or with ``causal=False`` every query over every
    key (whisper's encoder; a cross-attention, where k and v are the
    memory's, Skv != Sq). q: [B, Sq, Hq, Dh]; k, v: [B, Skv, Hkv, Dh].

    The kernel reads the [B, S, H, Dh] tensors through their strides (the
    transposes below are views) and writes [B, S, Hq, Dh] storage, so
    neither side makes a transposed copy on the card."""
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, q_pos, k_pos, *, window: int = 0):
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: [B, 1, Hq, Dh]; caches: [B, S, Hkv, Dh]; k_pos: [B, S] absolute
    positions (-1 for unwritten slots), or None (with ``q_pos``) to attend
    to every key, as the cross-attention does."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, dh)
    s = _scores_block(qg, k_cache, q_pos, k_pos, window)   # [B,Hkv,G,1,S]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.to(F32)) / l[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, dh)
    return o.to(q.dtype)


def _heads(x, w):
    """einsum('bsd,dhe->bshe') as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).view(*x.shape[:-1], h, e)


def _project_qkv(cfg: ModelConfig, p, x, positions, rope_theta: float):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def attention_out(p, out):
    """einsum('bshe,hed->bsd') as one matmul."""
    h, e, d = p["wo"].shape
    return out.reshape(*out.shape[:2], h * e) @ p["wo"].reshape(h * e, d)


def attention_apply(cfg: ModelConfig, p, x, positions, *,
                    cache: Optional[dict] = None, use_rope: bool = True,
                    window: Optional[int] = None):
    """Returns (y, new_cache). cache=None => prefill without cache emission.

    Decode (one token with a cache) writes the new key, value and position
    into the ring cache IN PLACE (the JAX server donates the cache to its
    decode step for the same effect) and returns the same tensors in the
    new cache dict. That is safe under replication only because the FT
    layer's ``copy_tree`` clones, so the replica's cache is its own."""
    theta = cfg.rope_theta if use_rope else 0.0
    win = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(cfg, p, x, positions, theta)

    if cache is None:
        out = prefill_attention(q, k, v, window=win)
        new_cache = None
    elif x.shape[1] == 1:
        slot = cache["idx"] % cache["k"].shape[1]
        _ring_write(cache["k"], k, slot)
        _ring_write(cache["v"], v, slot)
        cache["pos"][:, slot] = positions[:, 0].to(cache["pos"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], positions,
                               cache["pos"], window=win)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                     "idx": cache["idx"] + 1}
    else:
        out = prefill_attention(q, k, v, window=win)
        new_cache = init_cache_from(cfg, k, v, positions, win)

    y = attention_out(p, out)
    if cfg.attn_out_bias and "bo" in p:
        y = y + p["bo"]
    return y, new_cache


def _ring_write(cache: torch.Tensor, val: torch.Tensor, slot: int) -> None:
    """cache [B,S,H,D] <- val [B,1,H,D] at ``slot``, in place."""
    cache[:, slot] = val[:, 0].to(cache.dtype)


def init_cache_from(cfg: ModelConfig, k, v, positions, window: int,
                    headroom: int = CACHE_HEADROOM) -> dict:
    """Build a cache from prefill keys/values.

    Sliding-window archs get a ring buffer of exactly ``window`` slots;
    full-attention archs get ``headroom`` spare slots so decode appends
    instead of ring-overwriting history (decode writes at slot
    idx % capacity, starting at idx = prompt_len). ``idx`` is a host int."""
    b, s = k.shape[:2]
    if window:
        cap = min(s, window)
        k_c = k[:, s - cap:].clone()
        v_c = v[:, s - cap:].clone()
        pos_c = positions[:, s - cap:].to(torch.int32).clone()
    else:
        k_c = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, headroom))
        v_c = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, headroom))
        pos_c = torch.nn.functional.pad(positions.to(torch.int32),
                                        (0, headroom), value=-1)
    return {"k": k_c, "v": v_c, "pos": pos_c, "idx": s}


def empty_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                device) -> dict:
    """A zeroed KV cache for one layer."""
    dh = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device),
            "idx": 0}


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers, gated; whisper decoder, ungated)
# ---------------------------------------------------------------------------

def cross_attention_params(cfg: ModelConfig, dtype, device) -> dict:
    """Attention weights and a scalar ``gate`` (``init`` zeroes it, as the
    reference initialises it; whisper carries it unread)."""
    p = attention_params(cfg, dtype, device)
    p["gate"] = torch.zeros((), dtype=dtype, device=device)
    return p


def cross_attention_kv(cfg: ModelConfig, p, memory):
    """The memory's keys and values [B, M, Hkv, Dh], computed once at
    prefill and reused every decode step. Memory positions carry no RoPE.
    ``memory`` is taken in the weights' dtype (the reference's bf16 image
    embeddings promote to an f32 model's dtype the same way)."""
    memory = memory.to(p["wk"].dtype)
    k = _heads(memory, p["wk"])
    v = _heads(memory, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def cross_attention_apply(cfg: ModelConfig, p, x, memory=None, *, kv=None,
                          gated: bool = True):
    """x: [B, S, d] queries over ``memory`` [B, M, d] (no RoPE), or over
    its (k, v) from ``cross_attention_kv`` given as ``kv``. Every query
    sees every memory position: the prompt goes through
    ``ops.attention(causal=False)`` (K2 on the card, Sq != Skv), a decode
    token through the plain path, as decode self-attention does. ``gated``
    (the VLM) scales y by tanh(gate), the tanh in f32; whisper's layers
    are ungated."""
    k, v = cross_attention_kv(cfg, p, memory) if kv is None else kv
    q = _heads(x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    if x.shape[1] == 1:
        out = decode_attention(q, k, v, None, None)
    else:
        out = prefill_attention(q, k, v, causal=False)
    y = attention_out(p, out)
    if gated:
        y = y * torch.tanh(p["gate"].to(F32)).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# SwiGLU MLP, embedding
# ---------------------------------------------------------------------------

def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    g = x @ p["wg"]
    h = h * torch.nn.functional.silu(g.to(F32)).to(h.dtype)
    return h @ p["wo"]


def embed_lookup(p, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``p["embed"]`` at ``tokens``; under an active mesh
    (the dry run) the vocab-parallel lookup."""
    mesh = current_mesh()
    if mesh is not None:
        return parallel.sharded_lookup(p["embed"], tokens, mesh)
    return p["embed"][tokens]


def split_heads(t, *shape):
    """``t`` [..., H * dh] viewed as ``shape`` [..., H, dh]; under an
    active mesh first gathered where its shards would split a head."""
    mesh = current_mesh()
    if mesh is not None:
        t = parallel.whole_heads(t, shape[-2], mesh)
    return t.view(*shape)


def batch_parallel(fn, args, batched, n_out: int = 1):
    """``fn(*args)``; under an active mesh run on each rank's batch shard
    (``parallel.batch_parallel``)."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    return parallel.batch_parallel(fn, args, batched, n_out, mesh)


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["embed"].T
    return x @ w


def _chunk_loss(cfg: ModelConfig, p, xc: torch.Tensor,
                lc: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk of logsumexp(logits) - the label's logit, the
    logits in f32."""
    logits = unembed(cfg, p, xc).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    mesh = current_mesh()
    if mesh is not None:
        pick = parallel.sharded_pick(logits, lc, mesh)
    else:
        pick = logits.gather(-1, lc[..., None].long())[..., 0]
    return (lse - pick).sum()


def chunked_lm_loss(cfg: ModelConfig, p_embed, x: torch.Tensor,
                    labels: torch.Tensor, seq_chunk: int = 2048
                    ) -> torch.Tensor:
    """Mean cross-entropy without materialising [B, S, V] logits (port of
    ``repro/models/layers.py:423-459``): sequence chunks of ``seq_chunk``
    and a remainder chunk, each chunk's logits in f32, the label's logit
    picked by ``gather``; the sum divided by B * S. Each full chunk runs
    under ``torch.utils.checkpoint`` (the reference wraps the chunk body
    in ``jax.checkpoint``), so a [B, C, V] f32 logit block lives only
    while its chunk is computed, forward and backward."""
    b, s, _ = x.shape
    chunk = min(seq_chunk, s)
    n = s // chunk
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_loss, cfg, p_embed, x[:, sl],
                                   labels[:, sl], use_reentrant=False)
    if s - n * chunk:                      # the remainder chunk
        total = total + _chunk_loss(cfg, p_embed, x[:, n * chunk:],
                                    labels[:, n * chunk:])
    return total / (b * s)
