"""Model factory and parameter count (port of ``repro/models/api.py``:
every family of the reference)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# the expert weights under a layer's ``ffn`` (``models.moe.moe_params``)
_EXPERT_LEAVES = ("wi", "wg", "wo")


def build_model(cfg: ModelConfig, *, device=None):
    """The port's model for ``cfg`` on ``device`` (CUDA unless told
    otherwise), with uninitialised weights."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import Transformer
        return Transformer(cfg, device=device)
    if cfg.family == "audio":
        from repro_torch.models.whisper import Whisper
        return Whisper(cfg, device=device)
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import XLSTM
        return XLSTM(cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.zamba import Zamba
        return Zamba(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from a build on the ``meta`` device (no
    allocation). ``active_only``: MoE experts count at top_k / E of their
    weights (the 6 * N_active * D roofline convention), as the reference
    counts them: int(total - expert + expert * k / E)."""
    model = build_model(cfg, device="meta")
    total = expert = 0
    for name, p in model.named_parameters():
        total += p.numel()
        parts = name.split(".")
        if cfg.n_experts and "ffn" in parts and parts[-1] in _EXPERT_LEAVES:
            expert += p.numel()
    if active_only and cfg.n_experts:
        frac = cfg.n_experts_per_tok / cfg.n_experts
        return int(total - expert + expert * frac)
    return total
