"""Zamba2-style hybrid: Mamba2 backbone + ONE shared-weight attention block
(port of ``repro/models/zamba.py:29-192``, serving path).

Layer layout for n_layers = 81, attn_every = 6: 13 groups of [shared
attention, 6 Mamba2 blocks] + 3 tail Mamba2 blocks. The attention block's
weights are shared by every application, but each application has its own
KV cache at serve time.

The JAX model stacks its blocks on leading axes and scans over them; here
each block is one module, with the indices after the stacked name
(``mamba.2.5.in_x`` <-> ``mamba/in_x[2, 5]``, ``mamba_tail.1.a_log`` <->
``mamba_tail/a_log[1]``), so ``models.convert`` carries JAX weights across
by name. The cache is ``{"attn": [G dicts], "mamba": [G lists of k
states], "mamba_tail": [t states]}`` instead of stacked arrays.

Prefill attention is ``layers.prefill_attention`` (the K2 kernel on the
card), with a window only when the prompt is longer than it. Its cache is
a ring of ``min(S, sliding_window)`` slots, as in the reference: for a
prompt no longer than the window the first decode step overwrites the key
of position 0 (ROADMAP.md, F3 — reference behaviour, kept for parity).

Training differentiates ``loss_fn(cfg, params, batch)`` (module level, as
the dense family's): it takes the train state's params (a flat dict under
the state-dict names, nested by ``transformer.nest``), runs ``backbone``
with the shared block at window 0 (full causal attention, the reference's
``Zamba.loss_fn``) and the blocks without their serving state
(``mamba2.mamba2_branch``). The shared block's weights are read once a
group, so autograd sums their gradients over the groups.

As in the dense model the residual stream is carried as (x, r), r being
the last branch output not yet added: every norm that follows a residual
add (attention's two, each Mamba block's ``ln``, ``ln_f``) fuses the add
(``layers.add_rmsnorm``), in the JAX model's order of operations.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.transformer import ParamTree, nest


class Zamba(nn.Module):
    """Hybrid model: ``init`` / ``init_cache`` / ``prefill`` /
    ``decode_step``. Built on ``device`` (CUDA unless told otherwise) with
    uninitialised weights; ``init(generator)`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba is the hybrid family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        dev = device_lib.resolve(device)
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.tail = cfg.n_layers % cfg.attn_every

        def block():
            return ParamTree(M2.mamba2_params(cfg, self.dtype, dev))

        d = cfg.d_model
        self.embed = ParamTree(L.embed_params(cfg, self.dtype, dev))
        self.mamba = nn.ModuleList(
            nn.ModuleList(block() for _ in range(cfg.attn_every))
            for _ in range(self.n_groups))
        self.attn_ln = ParamTree(L.rmsnorm_params(d, self.dtype, dev))
        self.attn = ParamTree(L.attention_params(cfg, self.dtype, dev))
        self.attn_mlp_ln = ParamTree(L.rmsnorm_params(d, self.dtype, dev))
        self.attn_mlp = ParamTree(L.mlp_params(d, cfg.d_ff, self.dtype, dev))
        self.ln_f = ParamTree(L.rmsnorm_params(d, self.dtype, dev))
        if self.tail:
            self.mamba_tail = nn.ModuleList(block() for _ in range(self.tail))

    @property
    def device(self) -> torch.device:
        return self.ln_f["scale"].device

    # -- params ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Zamba":
        """Norm scales 1; ``a_log`` 0, ``d_skip`` 1, ``dt_bias`` -2,
        ``conv_b`` 0; ``conv_w`` normal * 2 * K^-1/2; every other matrix
        normal * fan_in^-1/2 — the JAX init's distribution (not its bits).
        ``gen`` must live on the model's device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in M2.CONST_INIT:
                p.fill_(M2.CONST_INIT[leaf])
            else:
                L.dense_init_(p, gen, M2.SCALED_INIT.get(leaf, 1.0))
        return self

    # -- serve ----------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        w = cfg.sliding_window
        cap = min(seq_len, w) if w else seq_len

        def state():
            return M2.empty_state(cfg, batch, self.dtype, dev)

        out = {"attn": [L.empty_cache(cfg, batch, cap, self.dtype, dev)
                        for _ in range(self.n_groups)],
               "mamba": [[state() for _ in group] for group in self.mamba]}
        if self.tail:
            out["mamba_tail"] = [state() for _ in self.mamba_tail]
        return out

    def _mlp(self, x, h):
        """The shared block's MLP after attention's output h: returns the
        stream x + h and the MLP's output, not yet added."""
        x, h = L.add_rmsnorm(self.attn_mlp_ln, x, h, self.cfg.norm_eps)
        return x, L.mlp_apply(self.attn_mlp, h)

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Process the full prompt; return (last_logits [B, 1, V], cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=tokens.device).expand(b, s)
        x, r = L.embed_lookup(self.embed, tokens), None
        win = cfg.sliding_window if s > cfg.sliding_window else 0
        attn, mamba = [], []
        for group in self.mamba:
            x, h = L.add_rmsnorm(self.attn_ln, x, r, cfg.norm_eps)
            q, k, v = L._project_qkv(cfg, self.attn, h, pos, cfg.rope_theta)
            out = L.prefill_attention(q, k, v, window=win)
            x, r = self._mlp(x, L.attention_out(self.attn, out))
            attn.append(L.init_cache_from(cfg, k, v, pos, cfg.sliding_window))
            states = []
            for mp in group:
                x, r, st = M2.mamba2_block(cfg, mp, x, r)
                states.append(st)
            mamba.append(states)
        cache = {"attn": attn, "mamba": mamba}
        if self.tail:
            cache["mamba_tail"] = []
            for mp in self.mamba_tail:
                x, r, st = M2.mamba2_block(cfg, mp, x, r)
                cache["mamba_tail"].append(st)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        return L.unembed(cfg, self.embed, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos):
        """tokens: [B, 1]; pos: [B, 1] absolute positions. Writes each
        attention application's ring cache in place (see
        ``layers.attention_apply``); the Mamba states are new tensors."""
        cfg = self.cfg
        x, r = L.embed_lookup(self.embed, tokens), None
        new = {"attn": [], "mamba": []}
        for group, ac, states in zip(self.mamba, cache["attn"],
                                     cache["mamba"]):
            x, h = L.add_rmsnorm(self.attn_ln, x, r, cfg.norm_eps)
            h, nac = L.attention_apply(cfg, self.attn, h, pos, cache=ac,
                                       window=cfg.sliding_window)
            x, r = self._mlp(x, h)
            new["attn"].append(nac)
            new_states = []
            for mp, st in zip(group, states):
                x, r, st = M2.mamba2_decode_block(cfg, mp, x, r, st)
                new_states.append(st)
            new["mamba"].append(new_states)
        if self.tail:
            new["mamba_tail"] = []
            for mp, st in zip(self.mamba_tail, cache["mamba_tail"]):
                x, r, st = M2.mamba2_decode_block(cfg, mp, x, r, st)
                new["mamba_tail"].append(st)
        _, x = L.add_rmsnorm(self.ln_f, x, r, cfg.norm_eps)
        return L.unembed(cfg, self.embed, x), new


# -- train ------------------------------------------------------------------

def backbone(cfg: ModelConfig, p: dict, x, positions):
    """The reference's ``Zamba.backbone`` at window 0 on nested params
    ``p``, through the same residual stream (x, r) and fused norms as
    ``Zamba.prefill``: returns ``ln_f`` of the stream."""
    n_groups = cfg.n_layers // cfg.attn_every
    r = None
    for g in range(n_groups):
        x, h = L.add_rmsnorm(p["attn_ln"], x, r, cfg.norm_eps)
        h, _ = L.attention_apply(cfg, p["attn"], h, positions, window=0)
        x, h = L.add_rmsnorm(p["attn_mlp_ln"], x, h, cfg.norm_eps)
        r = L.mlp_apply(p["attn_mlp"], h)
        for j in range(cfg.attn_every):
            x, r = M2.mamba2_branch(cfg, p["mamba"][str(g)][str(j)], x, r)
    for i in range(cfg.n_layers % cfg.attn_every):
        x, r = M2.mamba2_branch(cfg, p["mamba_tail"][str(i)], x, r)
    _, x = L.add_rmsnorm(p["ln_f"], x, r, cfg.norm_eps)
    return x


def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: dict,
            seq_chunk: int = 2048) -> torch.Tensor:
    """The f32 mean LM loss of ``params`` (state-dict names) on ``batch``
    (``tokens``, ``labels``: [B, S] integer tensors on the params' device):
    the reference's ``Zamba.loss_fn`` (``zamba.py:96-104``), differentiable."""
    p = nest(params)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = backbone(cfg, p, L.embed_lookup(p["embed"], tokens), positions)
    return L.chunked_lm_loss(cfg, p["embed"], x, labels, seq_chunk)
