from repro_torch.configs.base import (  # noqa: F401
    ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_arch,
    get_shape,
    reduced_config,
    register_arch,
    shape_skip_reason,
)

# Importing the arch modules registers them: the dense llama3.2-1b,
# stablelm-1.6b, starcoder2-3b and granite-34b, the vlm chameleon-34b, the
# MoE qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b (costed by the dry run,
# not served: launch/serve.py's NOT_SERVED), the SSM mamba2-370m, the
# hybrid zamba2-7b and the enc-dec (audio) seamless-m4t-medium.
from repro_torch.configs import chameleon_34b  # noqa: F401
from repro_torch.configs import granite_34b  # noqa: F401
from repro_torch.configs import llama32_1b  # noqa: F401
from repro_torch.configs import mamba2_370m  # noqa: F401
from repro_torch.configs import phi35_moe_42b_a6_6b  # noqa: F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
from repro_torch.configs import seamless_m4t_medium  # noqa: F401
from repro_torch.configs import stablelm_1_6b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import zamba2_7b  # noqa: F401
