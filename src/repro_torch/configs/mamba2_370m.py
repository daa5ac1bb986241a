"""Mamba2-370M — 48L d_model=1024, attention-free SSD (state-space duality),
ssm_state=128, vocab 50280. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_groups=1,
        conv_kernel=4,
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        num_function_groups=4,
        microbatches=2,
        source="arXiv:2405.21060",
    )
)
