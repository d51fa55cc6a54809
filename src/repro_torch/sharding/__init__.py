"""Sharding rules: logical axes -> mesh axes with divisibility fallbacks,
as DTensor placements on a ``DeviceMesh``."""
from .rules import (DEFAULT_RULES, NamedSharding, abstract_tree, batch_pspec,
                    cache_axes, constrain, current_mesh, decode_state_specs,
                    distribute_tree, placements_for, pspec_for,
                    shard_batch_specs, shard_decode_state, sharding_for,
                    tree_shardings, use_mesh)

__all__ = ["DEFAULT_RULES", "NamedSharding", "abstract_tree", "batch_pspec",
           "cache_axes", "constrain", "current_mesh", "decode_state_specs",
           "distribute_tree", "placements_for", "pspec_for",
           "shard_batch_specs", "shard_decode_state", "sharding_for",
           "tree_shardings", "use_mesh"]
