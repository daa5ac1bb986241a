from repro_torch.sharding.specs import (  # noqa: F401
    ALLOW_UNEVEN,
    LogicalRules,
    decode_rules,
    infer_rules,
    shard_as,
    to_named_sharding,
    to_placements,
    to_pspec,
    train_rules,
)
