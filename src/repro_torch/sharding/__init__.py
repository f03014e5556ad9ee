from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    MeshRules,
    NamedSharding,
    PartitionSpec,
    logical_sharding,
    logical_to_pspec,
    merged_rules,
    shard_constraint,
)
