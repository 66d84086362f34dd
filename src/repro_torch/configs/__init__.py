"""Arch registry of the port (see base.py)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    LayerGroups,
    MLAConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SHAPES,
    ShapeConfig,
    VisionStub,
    get_config,
    group_layers,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS", "LayerGroups", "MLAConfig", "MambaConfig", "ModelConfig",
    "MoEConfig", "RWKVConfig", "SHAPES", "ShapeConfig", "VisionStub",
    "get_config", "group_layers", "shape_applicable",
]
