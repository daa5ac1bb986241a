"""StableLM-2-1.6B — 24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_head=64,
        d_ff=5632,
        vocab_size=100352,
        act="silu",
        norm="layernorm",
        rope_theta=10000.0,
        num_function_groups=4,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
)
