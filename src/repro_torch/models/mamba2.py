"""Mamba2 block (SSD chunkwise-parallel scan), used by the Zamba2 hybrid
(port of ``repro/models/mamba2.py``).

Prefill pads the sequence to a chunk multiple and runs the SSD scan through
``kernels.ops.mamba_chunk_scan``: the hand-written CUDA kernel on the card,
the exact per-step recurrence on the CPU. Decode is the one-token
recurrence in plain PyTorch, as it is plain jnp in the JAX package.

Shapes: d_inner = expand * d_model; P = headdim (64); H = d_inner / P;
N = ssm_state; one B/C group (n_groups = 1, as in Zamba2). Parameter names
and layouts are the JAX ones (``in_z`` [d, d_inner], ``conv_w`` [K, C]).

One deliberate difference: the JAX model casts the intra-chunk score tile
and x to bf16 before their product (``mamba2.py:138-140``), even in an f32
model; the port follows the TPU kernel and ``kernels/ref.py`` and keeps the
scan in f32.

In a model the residual add of a block is left to the next norm, which
fuses it (``layers.add_rmsnorm``): ``mamba2_block`` and
``mamba2_decode_block`` take the stream as (x, r), r being the previous
branch's output, and return this block's output unadded. ``mamba2_apply``
and ``mamba2_decode`` are one block with the add done: x + out, bitwise
the same sum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32
HEADDIM = 64
# leaf name -> init (``Zamba.init``); every other matrix is dense_init_
CONST_INIT = {"scale": 1.0, "conv_b": 0.0, "a_log": 0.0, "d_skip": 1.0,
              "dt_bias": -2.0}
SCALED_INIT = {"conv_w": 2.0}


def dims(cfg: ModelConfig):
    """(d_inner, H, P, N)."""
    d_inner = cfg.expand * cfg.d_model
    p = min(HEADDIM, d_inner)
    return d_inner, d_inner // p, p, cfg.ssm_state


def mamba2_params(cfg: ModelConfig, dtype, device) -> dict:
    """Uninitialised block weights (``Zamba.init`` fills them). ``a_log``,
    ``d_skip`` and ``dt_bias`` are f32 in any model dtype."""
    d = cfg.d_model
    d_inner, h, _, n = dims(cfg)
    conv_dim = d_inner + 2 * n

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    return {
        "ln": L.rmsnorm_params(d, dtype, device),
        "in_z": empty(d, d_inner),
        "in_x": empty(d, d_inner),
        "in_b": empty(d, n),
        "in_c": empty(d, n),
        "in_dt": empty(d, h),
        "conv_w": empty(cfg.conv_kernel, conv_dim),
        "conv_b": empty(conv_dim),
        "a_log": empty(h, dt=F32),
        "d_skip": empty(h, dt=F32),
        "dt_bias": empty(h, dt=F32),
        "out_norm": L.rmsnorm_params(d_inner, dtype, device),
        "out_proj": empty(d_inner, d),
    }


def _project(prm, xn):
    """xn -> (z, xbc, dt_raw); xbc = concat(x, B, C) for the shared conv."""
    z = xn @ prm["in_z"]
    xbc = torch.cat([xn @ prm["in_x"], xn @ prm["in_b"], xn @ prm["in_c"]],
                    dim=-1)
    return z, xbc, xn @ prm["in_dt"]


def _causal_conv(xbc, w, b, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. xbc: [B,S,C]; w: [K,C].

    A shifted sum in xbc's dtype, taps 0..K-1 in order, then the bias, then
    SiLU in f32 (the JAX order; ``F.conv1d`` would sum in another order).
    conv_state: [B, K-1, C] trailing inputs of the previous segment.
    Returns (y, new_conv_state), the state being the last K-1 inputs."""
    k = w.shape[0]
    bsz, s, ch = xbc.shape
    if conv_state is None:
        pad = xbc.new_zeros((bsz, k - 1, ch))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return F.silu(y.to(F32)).to(xbc.dtype), new_state


def _split(cfg: ModelConfig, xbc):
    d_inner, _, _, n = dims(cfg)
    return xbc[..., :d_inner], xbc[..., d_inner:d_inner + n], \
        xbc[..., d_inner + n:]


def _gate_out(cfg: ModelConfig, prm, x, y, z):
    """out_norm, the SiLU(z) gate and the out-projection (the block's
    branch output, before the residual add)."""
    y = L.rmsnorm(prm["out_norm"], y, cfg.norm_eps)
    y = y * F.silu(z.to(F32)).to(x.dtype)
    return y @ prm["out_proj"]


def mamba2_apply(cfg: ModelConfig, prm, x, *, return_state: bool = False):
    """x: [B,S,d] -> x + the block's output. The scan starts from h = 0
    (no caller passes a state). With ``return_state`` also returns {"h":
    [B,H,P,N] f32, "conv": [B,K-1,conv_dim]}."""
    x, out, state = mamba2_block(cfg, prm, x)
    return (x + out, state) if return_state else x + out


def mamba2_block(cfg: ModelConfig, prm, x, r=None):
    """Prefill of one block on the stream (x, r). Returns (x + r, out,
    state): the stream, this block's output (not yet added) and the state
    as ``mamba2_apply`` returns it."""
    x, out, h_f, conv_state = _prefill(cfg, prm, x, r)
    # a copy, so the state does not keep the whole padded input alive
    return x, out, {"h": h_f, "conv": conv_state.to(x.dtype).clone()}


def mamba2_branch(cfg: ModelConfig, prm, x, r=None):
    """``mamba2_block`` without the state, for training: (x + r, out). The
    loss never reads the final h or the conv state, so neither is kept and
    no gradient reaches them."""
    x, out, _, _ = _prefill(cfg, prm, x, r)
    return x, out


def _prefill(cfg: ModelConfig, prm, x, r):
    """The block on (x, r): (x + r, out, the final h, the conv state as a
    view of the padded input)."""
    bsz, s, _ = x.shape
    d_inner, nh, p, n = dims(cfg)
    chunk = min(cfg.ssm_chunk, s)

    x, xn = L.add_rmsnorm(prm["ln"], x, r, cfg.norm_eps)
    z, xbc, dt_raw = _project(prm, xn)
    xbc, conv_state = _causal_conv(xbc, prm["conv_w"], prm["conv_b"])
    xs, bmat, cmat = _split(cfg, xbc)
    xs = xs.reshape(bsz, s, nh, p)
    dt = F.softplus(dt_raw.to(F32) + prm["dt_bias"])             # [B,S,H]
    a = -torch.exp(prm["a_log"])                                  # [H]
    da = dt * a                                                   # log decay

    # pad to a chunk multiple with zero-contribution steps: dt = 0 gives
    # decay 1 and no state update, so padded steps are exact no-ops
    pad = (-s) % chunk
    xs_p, b_p, c_p, dt_p, da_p = xs, bmat, cmat, dt, da
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b_p, c_p, dt_p, da_p = (F.pad(t, (0, 0, 0, pad))
                                for t in (bmat, cmat, dt, da))
    y, h_f = ops.mamba_chunk_scan(xs_p, b_p, c_p, dt_p, da_p, chunk=chunk,
                                  out_dtype=F32)
    y = y[:, :s] + xs.to(F32) * prm["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    return x, _gate_out(cfg, prm, x, y, z), h_f, conv_state


def mamba2_decode(cfg: ModelConfig, prm, x, state: dict):
    """One-token recurrence. x: [B,1,d]; state as ``mamba2_apply`` returns
    it. Returns (x + the block's output, new_state); the state tensors are
    new."""
    x, out, state = mamba2_decode_block(cfg, prm, x, None, state)
    return x + out, state


def mamba2_decode_block(cfg: ModelConfig, prm, x, r, state: dict):
    """``mamba2_decode`` on the stream (x, r): returns (x + r, out,
    new_state), the block's output not yet added."""
    bsz = x.shape[0]
    d_inner, nh, p, _ = dims(cfg)
    x, xn = L.add_rmsnorm(prm["ln"], x, r, cfg.norm_eps)
    z, xbc, dt_raw = _project(prm, xn)
    xbc, conv_state = _causal_conv(xbc, prm["conv_w"], prm["conv_b"],
                                   state["conv"])
    xs, bmat, cmat = _split(cfg, xbc)
    xt = xs[:, 0].reshape(bsz, nh, p).to(F32)
    bt = bmat[:, 0].to(F32)                                        # [B,N]
    ct = cmat[:, 0].to(F32)
    dt = F.softplus(dt_raw[:, 0].to(F32) + prm["dt_bias"])        # [B,H]
    dec = torch.exp(dt * -torch.exp(prm["a_log"]))                # [B,H]
    upd = (xt * dt[:, :, None])[..., None] * bt[:, None, None, :]
    h = state["h"].to(F32) * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", ct, h)
    y = y + xt * prm["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    out = _gate_out(cfg, prm, x, y, z)
    return x, out, {"h": h, "conv": conv_state.to(x.dtype)}


def empty_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, nh, p, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {"h": torch.zeros((batch, nh, p, n), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device)}
