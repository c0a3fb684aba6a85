"""xLSTM backbone: mLSTM (chunkwise-parallel matrix memory) and sLSTM
blocks, the SSM family (port of ``repro/models/xlstm.py``).

Layout: ``n_layers`` blocks in G groups of (``slstm_every`` - 1) mLSTM
blocks and one sLSTM block. The reference stacks each kind and scans over
them; here each block is one module (``mlstm.2.4.w_up`` <->
``mlstm/w_up[2, 4]``, ``slstm.2.r_gates`` <-> ``slstm/r_gates[2]``), so
``models.convert`` carries JAX weights across by name. The serving state
is recurrent, all f32, with no KV ring: ``{"mlstm": [G lists of {"C" [B,
H, dk, dv], "n" [B, H, dk]}], "slstm": [G dicts of "h", "c", "n", "m" [B,
H, dh]]}``.

Neither block has a TPU kernel in the reference, so both are plain
PyTorch here and copy the reference's arithmetic, casts included: the
mLSTM rounds its weighted score tile and v to bf16 before the intra-chunk
product, accumulated in f32 (``xlstm.py:101-103``), even in an f32 model.
The sLSTM scan is sequential, one step a token, in a fixed order of
operations. Only the norms reach a kernel (K1, ``layers.add_rmsnorm``).

In a model the residual add of a block is left to the next norm, which
fuses it: ``mlstm_block``, ``mlstm_decode_block`` and ``slstm_block`` take
the stream as (x, r), r being the previous branch's output, and return
this block's output unadded. ``mlstm_apply``, ``mlstm_decode`` and
``slstm_apply`` are one block with the add done (the reference's
functions): x + out, bitwise the same sum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import ParamTree, nest
from repro_torch.models.trips import pad, trips

F32 = torch.float32
CHUNK = 256
# leaf name -> init (``XLSTM.init``); every other matrix is dense_init_
CONST_INIT = {"scale": 1.0, "bf": 3.0, "b_gates": 0.0}
M_INIT = -30.0          # the sLSTM stabilizer's start


def _heads(cfg: ModelConfig):
    """(H, dh): the blocks split d_model over cfg.n_heads."""
    return cfg.n_heads, cfg.d_model // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_params(cfg: ModelConfig, dtype, dev) -> dict:
    d, h = cfg.d_model, cfg.n_heads

    def w(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)
    return {"ln": L.rmsnorm_params(d, dtype, dev), "w_up": w(d, 2 * d),
            "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wi": w(d, h),
            "wf": w(d, h), "bf": w(h), "w_down": w(d, d)}


def _key_scale(dh: int, dtype) -> float:
    """dh^1/2 as the reference divides by it: a Python scalar, which JAX
    takes in the keys' dtype."""
    return float(torch.tensor(dh ** 0.5, dtype=F32).to(dtype))


def _mlstm_qkvif(cfg: ModelConfig, p, xn):
    """q, k, v [B, S, H, dh] in the model dtype (k / dh^1/2), the input
    gate sigmoid(i) and the log forget gate log_sigmoid(f + bf) [B, S, H]
    in f32, and the output gate's pre-activation z. ``xn`` is the block's
    normed input (the reference normalises inside)."""
    b, s, d = xn.shape
    h, dh = _heads(cfg)
    v_in, z = (xn @ p["w_up"]).chunk(2, dim=-1)
    q = L.split_heads(v_in @ p["wq"], b, s, h, dh)
    k = L.split_heads(v_in @ p["wk"], b, s, h, dh)
    v = L.split_heads(v_in @ p["wv"], b, s, h, dh)
    k = k / _key_scale(dh, k.dtype)
    ig = torch.sigmoid((xn @ p["wi"]).to(F32))
    fg = F.logsigmoid((xn @ p["wf"] + p["bf"]).to(F32))
    return q, k, v, ig, fg, z


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and read back in f32: an f32 product of two
    such operands is the reference's bf16 x bf16 einsum with f32
    accumulation (``preferred_element_type=F32``)."""
    return t.to(torch.bfloat16).to(F32)


def _mlstm_chunk(qc, kc, vc, ic, fc, c, n, tri):
    """One chunk of the reference's scan body (``xlstm.py:85-115``): the
    chunk's y [B, T, H, dv] and the carried (C, n) after it."""
    ld = torch.cumsum(fc, dim=1)                          # [B,T,H] log decay
    # intra-chunk: W[t,s] = exp(ld_t - ld_s) * i_s  for s <= t
    wmask = (ld[:, :, None, :] - ld[:, None, :, :]) + torch.log(
        torch.clamp(ic, min=1e-9))[:, None, :, :]
    wts = torch.where(tri[None, :, :, None], torch.exp(wmask), 0.0)
    qf, kf, vf = qc.to(F32), kc.to(F32), vc.to(F32)
    scores = torch.einsum("bthd,bshd->btsh", qf, kf)
    wsc = scores * wts
    y_intra = torch.einsum("btsh,bshd->bthd", _bf16(wsc), _bf16(vc))
    den_intra = wsc.sum(dim=2)
    # inter-chunk: the carried state's contribution
    dec_t = torch.exp(ld)
    y_inter = torch.einsum("bthd,bhde,bth->bthe", qf, c, dec_t)
    den_inter = torch.einsum("bthd,bhd,bth->bth", qf, n, dec_t)
    den = torch.clamp(torch.abs(den_intra + den_inter), min=1.0)
    y = (y_intra + y_inter) / den[..., None]
    ld_tot = ld[:, -1, :]                                 # [B,H]
    w_s = torch.exp(ld_tot[:, None, :] - ld) * ic
    c = torch.exp(ld_tot)[:, :, None, None] * c + torch.einsum(
        "bshd,bshe,bsh->bhde", kf, vf, w_s)
    n = torch.exp(ld_tot)[:, :, None] * n + torch.einsum(
        "bshd,bsh->bhd", kf, w_s)
    return y, c, n


def _mlstm_scan(q, k, v, ig, fg, c, n, chunk: int):
    """The chunks in order from the state (C, n): (y [B, S, H, dv], C,
    n)."""
    s = q.shape[1]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    ys = []
    for i in range(trips("mlstm", s // chunk)):
        sl = slice(i * chunk, (i + 1) * chunk)
        y, c, n = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                               fg[:, sl], c, n, tri)
        ys.append(y)
    return torch.cat(pad(ys, s // chunk), dim=1), c, n


def mlstm_block(cfg: ModelConfig, p, x, r, *, chunk: int = CHUNK,
                state: Optional[dict] = None):
    """One mLSTM block on the stream (x, r), chunkwise over the sequence
    from ``state`` (zeros if None). Returns (x, out, {"C", "n"}): the
    stream with r added, the block's output not yet added, its final
    state. The sequence must be at most ``chunk`` long or a multiple of
    it (the reference cannot reshape another; this raises rather than
    drop tokens)."""
    b, s, d = x.shape
    h, dh = _heads(cfg)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mLSTM sequence length {s} is neither at most "
                         f"{chunk} nor a multiple of it")
    x, xn = L.add_rmsnorm(p["ln"], x, r, cfg.norm_eps)
    q, k, v, ig, fg, z = _mlstm_qkvif(cfg, p, xn)
    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=F32, device=x.device)
        n = torch.zeros((b, h, dh), dtype=F32, device=x.device)
    else:
        c, n = state["C"].to(F32), state["n"].to(F32)
    y, c, n = L.batch_parallel(_mlstm_scan, (q, k, v, ig, fg, c, n, chunk),
                               (True,) * 7 + (None,), n_out=3)
    y = y.reshape(b, s, d).to(x.dtype)
    y = y * F.silu(z.to(F32)).to(x.dtype)
    return x, y @ p["w_down"], {"C": c, "n": n}


def mlstm_apply(cfg: ModelConfig, p, x, *, chunk: int = CHUNK, state=None,
                return_state: bool = False):
    """x: [B, S, d] -> x + the block's output (and its final state): the
    reference's ``mlstm_apply``."""
    x, out, st = mlstm_block(cfg, p, x, None, chunk=chunk, state=state)
    return (x + out, st) if return_state else x + out


def mlstm_decode_block(cfg: ModelConfig, p, x, r, state: dict):
    """One-token recurrent update on the stream (x, r), x [B, 1, d]:
    (x, out, new state), as ``mlstm_block``."""
    b, _, d = x.shape
    x, xn = L.add_rmsnorm(p["ln"], x, r, cfg.norm_eps)
    q, k, v, ig, fg, z = _mlstm_qkvif(cfg, p, xn)
    q, k, v = (a[:, 0].to(F32) for a in (q, k, v))        # [B,H,dh]
    i_t = ig[:, 0]                                        # [B,H]
    f_t = torch.exp(fg[:, 0])
    c = state["C"].to(F32) * f_t[:, :, None, None] + \
        torch.einsum("bhd,bhe,bh->bhde", k, v, i_t)
    n = state["n"].to(F32) * f_t[:, :, None] + k * i_t[:, :, None]
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), min=1.0)
    y = (num / den[..., None]).reshape(b, 1, d).to(x.dtype)
    y = y * F.silu(z.to(F32)).to(x.dtype)
    return x, y @ p["w_down"], {"C": c, "n": n}


def mlstm_decode(cfg: ModelConfig, p, x, state: dict):
    """The reference's ``mlstm_decode``: (x + out, new state)."""
    x, out, st = mlstm_decode_block(cfg, p, x, None, state)
    return x + out, st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(cfg: ModelConfig, dtype, dev) -> dict:
    d = cfg.d_model
    h, dh = _heads(cfg)
    f_in = int(d * 4 / 3) // 128 * 128 or d
    return {"ln": L.rmsnorm_params(d, dtype, dev),
            "w_gates": torch.empty((d, 4 * d), dtype=dtype, device=dev),
            "r_gates": torch.empty((h, dh, 4 * dh), dtype=dtype, device=dev),
            "b_gates": torch.empty((4 * d,), dtype=dtype, device=dev),
            "up": L.mlp_params(d, f_in, dtype, dev)}


def _slstm_scan(cfg: ModelConfig, p, gx, h0, c0, n0, m0):
    """The sequential scan over gx [B, S, 4d], the input gates' part, from
    (h, c, n, m) [B, H, dh] f32: returns (h of every step [B, S, d] f32,
    the final (h, c, n, m)). Each step runs the reference's operations in
    its order; the loop keeps the heads leading ([H, B, .]) so that the
    recurrent product is one ``bmm`` a step, the same sums."""
    b, s, d4 = gx.shape
    h, dh = _heads(cfg)
    rg = p["r_gates"].to(F32)                             # [H, dh, 4dh]
    g_all = gx.to(F32).view(b, s, h, 4 * dh).permute(1, 2, 0, 3) \
        .contiguous()                                     # [S, H, B, 4dh]
    hp, cp, np_, mp = (t.transpose(0, 1) for t in (h0, c0, n0, m0))
    ys = []
    for t in range(trips("slstm", s)):
        g = g_all[t] + torch.bmm(hp, rg)
        z, i_, f, o = g.chunk(4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        lfm = F.logsigmoid(f) + mp
        m_new = torch.maximum(lfm, i_)
        i_p = torch.exp(i_ - m_new)
        f_p = torch.exp(lfm - m_new)
        cp = f_p * cp + i_p * z
        np_ = torch.clamp(f_p * np_ + i_p, min=1e-6)
        hp = o * cp / np_
        mp = m_new
        ys.append(hp)
    y = torch.stack(pad(ys, s)).permute(2, 0, 1, 3).reshape(b, s, h * dh)
    return y, tuple(t.transpose(0, 1) for t in (hp, cp, np_, mp))


def _slstm_steps(cfg: ModelConfig, r_gates, gx, h0, c0, n0, m0):
    """``_slstm_scan`` with its outputs flat: (y, h, c, n, m)."""
    y, state = _slstm_scan(cfg, {"r_gates": r_gates}, gx, h0, c0, n0, m0)
    return (y, *state)


def _slstm_start(cfg: ModelConfig, b: int, device):
    h, dh = _heads(cfg)
    zeros = torch.zeros((b, h, dh), dtype=F32, device=device)
    return {"h": zeros, "c": zeros, "n": zeros,
            "m": torch.full((b, h, dh), M_INIT, dtype=F32, device=device)}


def slstm_block(cfg: ModelConfig, p, x, r, *, state: Optional[dict] = None):
    """One sLSTM block on the stream (x, r), from ``state`` (h, c, n 0 and
    m -30 if None): (x, out, final {"h", "c", "n", "m"}), as
    ``mlstm_block``."""
    x, xn = L.add_rmsnorm(p["ln"], x, r, cfg.norm_eps)
    gx = xn @ p["w_gates"] + p["b_gates"]
    st = _slstm_start(cfg, x.shape[0], x.device) if state is None else state
    y, hf, cf, nf, mf = L.batch_parallel(
        lambda *a: _slstm_steps(cfg, *a),
        (p["r_gates"], gx, st["h"], st["c"], st["n"], st["m"]),
        (False,) + (True,) * 5, n_out=5)
    out = L.mlp_apply(p["up"], y.to(x.dtype))
    return x, out, {"h": hf, "c": cf, "n": nf, "m": mf}


def slstm_apply(cfg: ModelConfig, p, x, *, state=None,
                return_state: bool = False):
    """The reference's ``slstm_apply``: x + the block's output (and its
    final state)."""
    x, out, st = slstm_block(cfg, p, x, None, state=state)
    return (x + out, st) if return_state else x + out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _groups(cfg: ModelConfig):
    k = cfg.slstm_every
    if not k or cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} is not a whole number "
                         f"of groups of {k}")
    return cfg.n_layers // k, k - 1


def _group_trees(p, g: int, mpg: int):
    """Group g's mLSTM block trees and its sLSTM block tree, from the
    model or from nested train-state params."""
    m, s = p["mlstm"], p["slstm"]
    if isinstance(m, dict):
        return [m[str(g)][str(j)] for j in range(mpg)], s[str(g)]
    return list(m[g]), s[g]


def backbone(cfg: ModelConfig, p, x, *, chunk: int = CHUNK):
    """The reference's ``XLSTM.backbone`` on ``p`` (the model or nested
    train params): every group's mLSTM blocks then its sLSTM block, then
    ``ln_f`` of the stream."""
    n_groups, mpg = _groups(cfg)
    r = None
    for g in range(n_groups):
        mps, sp = _group_trees(p, g, mpg)
        for mp in mps:
            x, r, _ = mlstm_block(cfg, mp, x, r, chunk=chunk)
        x, r, _ = slstm_block(cfg, sp, x, r)
    return L.add_rmsnorm(p["ln_f"], x, r, cfg.norm_eps)[1]


class XLSTM(nn.Module):
    """xLSTM: ``init`` / ``init_cache`` / ``prefill`` / ``decode_step``.
    Built on ``device`` (CUDA unless told otherwise) with uninitialised
    weights; ``init(generator)`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"XLSTM is the ssm family, not {cfg.family!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.n_groups, self.m_per_group = _groups(cfg)
        dev = device_lib.resolve(device)
        self.embed = ParamTree(L.embed_params(cfg, self.dtype, dev))
        self.mlstm = nn.ModuleList(
            nn.ModuleList(ParamTree(mlstm_params(cfg, self.dtype, dev))
                          for _ in range(self.m_per_group))
            for _ in range(self.n_groups))
        self.slstm = nn.ModuleList(
            ParamTree(slstm_params(cfg, self.dtype, dev))
            for _ in range(self.n_groups))
        self.ln_f = ParamTree(L.rmsnorm_params(cfg.d_model, self.dtype, dev))

    def __getitem__(self, key: str):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.ln_f["scale"].device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "XLSTM":
        """Norm scales 1, the forget-gate bias ``bf`` 3 (open gates), the
        sLSTM gate bias 0, every other matrix normal * fan_in^-1/2 (fan_in
        the leading dim, ``r_gates``' heads included) — the JAX init's
        distribution (not its bits). ``gen`` must live on the model's
        device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in CONST_INIT:
                p.fill_(CONST_INIT[leaf])
            else:
                L.dense_init_(p, gen)
        return self

    # -- serve: recurrent state -----------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> dict:
        h, dh = _heads(self.cfg)
        dev = self.device

        def m_state():
            return {"C": torch.zeros((batch, h, dh, dh), dtype=F32,
                                     device=dev),
                    "n": torch.zeros((batch, h, dh), dtype=F32, device=dev)}

        def s_state():
            st = _slstm_start(self.cfg, batch, dev)
            return {k: t.clone() for k, t in st.items()}
        return {"mlstm": [[m_state() for _ in group] for group in self.mlstm],
                "slstm": [s_state() for _ in self.slstm]}

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Process the prompt; return (last_logits [B, 1, V], state)."""
        cfg = self.cfg
        x, r = L.embed_lookup(self.embed, batch["tokens"]), None
        cache = {"mlstm": [], "slstm": []}
        for group, sp in zip(self.mlstm, self.slstm):
            states = []
            for mp in group:
                x, r, st = mlstm_block(cfg, mp, x, r)
                states.append(st)
            x, r, st = slstm_block(cfg, sp, x, r)
            cache["mlstm"].append(states)
            cache["slstm"].append(st)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        return L.unembed(cfg, self.embed, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos):
        """tokens: [B, 1] (``pos`` is unused: the state is recurrent).
        Every state tensor of the result is new."""
        cfg = self.cfg
        x, r = L.embed_lookup(self.embed, tokens), None
        new = {"mlstm": [], "slstm": []}
        for group, sp, m_states, s_state in zip(
                self.mlstm, self.slstm, cache["mlstm"], cache["slstm"]):
            states = []
            for mp, st in zip(group, m_states):
                x, r, st = mlstm_decode_block(cfg, mp, x, r, st)
                states.append(st)
            x, r, st = slstm_block(cfg, sp, x, r, state=s_state)
            new["mlstm"].append(states)
            new["slstm"].append(st)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        return L.unembed(cfg, self.embed, x), new


# -- train ------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: dict,
            seq_chunk: int = 2048) -> torch.Tensor:
    """The f32 mean LM loss of ``params`` (state-dict names) on ``batch``
    (``tokens``, ``labels``: [B, S] integer tensors on the params'
    device): the reference's ``XLSTM.loss_fn`` (``xlstm.py:261-266``),
    differentiable."""
    p = nest(params)
    x = backbone(cfg, p, L.embed_lookup(p["embed"], batch["tokens"]))
    return L.chunked_lm_loss(cfg, p["embed"], x, batch["labels"], seq_chunk)
