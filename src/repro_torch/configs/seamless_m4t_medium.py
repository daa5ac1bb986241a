"""SeamlessM4T-medium — enc-dec, 12L encoder + 12L decoder, d_model=1024
16H (MHA kv=16) d_ff=4096 vocab=256206, multimodal (audio frontend stub
provides frame embeddings). [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,            # encoder layers
        num_decoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab_size=256206,
        act="gelu",
        norm="layernorm",
        rope_theta=10000.0,
        frontend="audio",
        num_function_groups=2,    # encoder fn + decoder fn: the canonical sync edge
        microbatches=4,  # train_4k fits 16GB/chip with grad accumulation
        source="arXiv:2308.11596",
    )
)
