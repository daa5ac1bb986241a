"""Qwen3-MoE-30B-A3B — 48L d_model=2048 32H (GQA kv=4) MoE 128e top-8,
per-expert d_ff=768, vocab 151936. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_head=128,
        d_ff=0,                 # all layers are MoE
        moe_d_ff=768,
        num_experts=128,
        num_experts_per_tok=8,
        vocab_size=151936,
        act="silu",
        norm="rmsnorm",
        qk_norm=True,           # qwen3 uses per-head q/k RMSNorm
        rope_theta=1e6,
        num_function_groups=6,
        moe_impl="dropping_ep",  # the JAX package's expert-parallel schedule; one card runs g = 1
        microbatches=4,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
)
