from repro_torch.configs.base import (  # noqa: F401
    ARCHS,
    ModelConfig,
    ShapeConfig,
    get_arch,
    reduced_config,
    register_arch,
)

# Importing the arch modules registers them (the dense llama3.2-1b, the MoE
# qwen3-moe-30b-a3b, the SSM mamba2-370m and the hybrid zamba2-7b).
from repro_torch.configs import llama32_1b  # noqa: F401
from repro_torch.configs import mamba2_370m  # noqa: F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
from repro_torch.configs import zamba2_7b  # noqa: F401
