from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    RunConfig,
    ShapeConfig,
    get_config,
    get_smoke_config,
    list_archs,
)
