"""Chameleon-34B — 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536,
early-fusion VQ image tokens (frontend stub provides patch embeddings).
[arXiv:2405.09818]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab_size=65536,
        act="silu",
        norm="rmsnorm",
        qk_norm=True,           # chameleon stabilizes with QK-norm
        rope_theta=10000.0,
        frontend="vlm",
        num_function_groups=6,
        microbatches=4,  # train_4k fits 16GB/chip with grad accumulation
        source="arXiv:2405.09818",
    )
)
