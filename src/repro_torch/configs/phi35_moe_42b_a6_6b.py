"""Phi-3.5-MoE-42B-A6.6B — 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
MoE 16e top-2, vocab 32064. [hf:microsoft/Phi-3.5-MoE-instruct]

Without a device mesh ``dropping_ep`` runs as ``dropping``
(``models/moe.py``); ``launch/serve.py`` does not serve it (``NOT_SERVED``:
its bf16 weights exceed one card), the dry run works out its costs."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_head=128,
        d_ff=0,
        moe_d_ff=6400,
        num_experts=16,
        num_experts_per_tok=2,
        vocab_size=32064,
        act="silu",
        norm="layernorm",
        rope_theta=10000.0,
        num_function_groups=4,
        moe_impl="dropping_ep",  # the JAX package's expert-parallel schedule; one card runs g = 1
        microbatches=8,
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
)
