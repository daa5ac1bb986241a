"""StarCoder2-3B — 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152,
GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_head=128,
        d_ff=12288,
        vocab_size=49152,
        act="gelu",
        norm="layernorm",
        rope_theta=1e5,
        num_function_groups=4,
        source="arXiv:2402.19173",
    )
)
