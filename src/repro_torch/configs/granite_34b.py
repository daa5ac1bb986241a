"""Granite-34B-Code — 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
[arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",
        norm="layernorm",
        rope_theta=10000.0,
        tie_embeddings=True,
        num_function_groups=8,
        microbatches=4,  # train_4k fits 16GB/chip with grad accumulation
        source="arXiv:2405.04324",
    )
)
