from repro_torch.configs.base import (  # noqa: F401
    ARCHS,
    ModelConfig,
    ShapeConfig,
    get_arch,
    reduced_config,
    register_arch,
)

# Importing the arch modules registers them (this slice ports the dense
# llama3.2-1b configuration only).
from repro_torch.configs import llama32_1b  # noqa: F401
