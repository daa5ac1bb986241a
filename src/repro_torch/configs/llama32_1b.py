"""Llama-3.2-1B — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_head=64,
        d_ff=8192,
        vocab_size=128256,
        act="silu",
        norm="rmsnorm",
        rope_theta=500000.0,
        tie_embeddings=True,
        num_function_groups=4,
        source="hf:meta-llama/Llama-3.2-1B",
    )
)
