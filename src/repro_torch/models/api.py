"""Model factory and parameter count (port of ``repro/models/api.py``:
the dense and hybrid families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# where each family not ported yet stands in ROADMAP.md's Queue 1
_NOT_PORTED = {"moe": 5, "vlm": 6, "audio": 7, "ssm": 8}


def build_model(cfg: ModelConfig, *, device=None):
    """The port's model for ``cfg`` on ``device`` (CUDA unless told
    otherwise), with uninitialised weights."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import Transformer
        return Transformer(cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.zamba import Zamba
        return Zamba(cfg, device=device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to PyTorch yet "
            f"(ROADMAP.md, Queue 1 item {_NOT_PORTED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from a build on the ``meta`` device (no
    allocation). ``active_only`` matters only for MoE, which is not
    ported, so for the ported families both counts agree."""
    del active_only
    model = build_model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
