"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import (
    FTConfig,
    MeshConfig,
    ModelConfig,
    MULTI_POD,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SINGLE_POD,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
)

from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN1_5_110B
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R_35B
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as LLAMA_3_2_VISION_11B
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        MIXTRAL_8X7B,
        MIXTRAL_8X22B,
        QWEN3_8B,
        QWEN1_5_110B,
        COMMAND_R_35B,
        CODEQWEN1_5_7B,
        WHISPER_TINY,
        XLSTM_350M,
        LLAMA_3_2_VISION_11B,
        ZAMBA2_7B,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def as_config(arch: "str | ModelConfig", reduced: bool) -> ModelConfig:
    """``arch`` as a config: a ``ModelConfig`` (a depth-cut one, say) as
    given, a name looked up, and reduced if asked."""
    if isinstance(arch, ModelConfig):
        return arch
    cfg = get_arch(arch)
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells(include_inapplicable: bool = False):
    """All (arch, shape) dry-run cells. long_500k only for sub-quadratic archs
    unless ``include_inapplicable``; whisper decode shapes always run (enc-dec
    has a decoder)."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            applicable = True
            if shape.name == "long_500k" and not arch.is_subquadratic:
                applicable = False
            if applicable or include_inapplicable:
                out.append((arch, shape, applicable))
    return out


__all__ = [
    "ARCHS", "get_arch", "as_config", "get_shape", "cells",
    "ModelConfig", "ShapeConfig", "MeshConfig", "FTConfig", "RunConfig",
    "SHAPES", "SINGLE_POD", "MULTI_POD",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
