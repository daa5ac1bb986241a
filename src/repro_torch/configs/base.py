"""Model + shape configuration registry.

Every assigned architecture is a :class:`ModelConfig`; every assigned input
shape is a :class:`ShapeConfig`. A dry-run cell is the pair. The fields
mirror the JAX package's, so a config carries across unchanged; the port
reads those of the dense, vlm, MoE, SSM, hybrid and enc-dec (audio)
families.
"""
from __future__ import annotations

import dataclasses

FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dropping"     # dropping (capacity gather/scatter) | ragged (dropless)
    moe_min_group_tokens: int = 0  # 0 = auto (see moe.py group heuristic)
    router_aux_weight: float = 0.01
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    # --- hybrid (zamba2): shared transformer block applied every k layers ---
    shared_attn_every: int = 0
    # --- enc-dec ---
    num_decoder_layers: int = 0
    # --- misc arch knobs ---
    act: str = "silu"
    norm: str = "rmsnorm"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    frontend: str = "none"         # none | audio | vlm (stub embeddings per spec)
    # --- platform deployment: Provuse function-chain granularity ---
    num_function_groups: int = 4
    # --- serving ---
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | float8_e4m3fn (quantized KV)
    # --- training knobs ---
    remat: bool = True
    microbatches: int = 1
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(1, self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in SUBQUADRATIC_FAMILIES


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHS: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k needs sub-quadratic sequence handling: run it only for
    SSM / hybrid archs (skip for pure full-attention — DESIGN.md §4)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


def shape_skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 524k-token decode requires sub-quadratic attention (DESIGN.md §4)"
    return None


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    changes: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 256) if cfg.vocab_size else 0,
        d_head=16 if cfg.num_heads else 0,
        num_heads=min(cfg.num_heads, 4) if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, max(1, min(cfg.num_kv_heads, 2))) if cfg.num_kv_heads else 0,
        remat=False,
        microbatches=1,
        num_function_groups=2,
    )
    if cfg.num_experts:
        changes.update(num_experts=min(cfg.num_experts, 4), num_experts_per_tok=min(cfg.num_experts_per_tok, 2), moe_d_ff=32)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.shared_attn_every:
        changes.update(shared_attn_every=2, num_layers=5)  # 2 groups of 2 + tail of 1
    if cfg.num_decoder_layers:
        changes.update(num_decoder_layers=2)
    return dataclasses.replace(cfg, **changes)
