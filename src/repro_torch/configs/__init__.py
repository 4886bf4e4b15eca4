from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    all_configs,
    get_config,
    get_shape,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "get_shape",
]
