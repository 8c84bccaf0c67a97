"""Config registry of the 10 LM architectures: a copy of
``repro/configs/__init__.py`` (the configs are data; the port keeps its own
copy so that it imports nothing of the JAX package)."""
from repro_torch.configs.base import (ArchConfig, LayerProgram, Segment,
                                      ShapeConfig, SHAPES, depth_scaled,
                                      full_groups, reduced)

from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.gemma3_12b import CONFIG as gemma3_12b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.granite_moe_1b import CONFIG as granite_moe_1b
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.paligemma_3b import CONFIG as paligemma_3b

ARCHS = {c.name: c for c in [
    zamba2_7b, whisper_tiny, starcoder2_15b, qwen3_8b, gemma3_12b,
    qwen2_0_5b, mamba2_2_7b, granite_moe_1b, mixtral_8x22b, paligemma_3b,
]}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")
