from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SMOKE_SHAPE,
    SMOKE_DECODE_SHAPE,
    applicable_shapes,
    get_config,
    list_configs,
    reduced,
    register,
)
