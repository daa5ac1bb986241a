"""Zamba2-7B — 81L d_model=3584, Mamba2 backbone + shared attention block
(32H MHA, d_ff=14336) applied every 6th layer, ssm_state=64, vocab 32000.
81 layers = 13 groups of 6 + tail of 3. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_groups=1,
        conv_kernel=4,
        shared_attn_every=6,
        act="silu",
        norm="rmsnorm",
        num_function_groups=4,
        microbatches=4,
        source="arXiv:2411.15242",
    )
)
