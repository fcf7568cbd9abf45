"""Logical sharding on a ``DeviceMesh`` with DTensor (the port of
``repro.sharding``).  The reference's ``shard_map`` compat wrapper has no
counterpart: the port's kernels take local shards through
``torch.distributed.tensor.experimental.local_map`` or explicit
collectives."""
from .specs import (
    ACT_RULES,
    axis_sizes,
    get_mesh,
    logical,
    placements,
    replicate,
    set_act_rules,
    set_mesh,
    shard,
    shard_cache_kv,
    shard_cache_latent,
    shard_decode_logits,
    spec_of,
    use_mesh,
)

__all__ = [
    "ACT_RULES",
    "axis_sizes",
    "get_mesh",
    "logical",
    "placements",
    "replicate",
    "set_act_rules",
    "set_mesh",
    "shard",
    "shard_cache_kv",
    "shard_cache_latent",
    "shard_decode_logits",
    "spec_of",
    "use_mesh",
]
