"""Key-range sharded conflict detection: the port of
``foundationdb_tpu/parallel/``.

The reference scales conflict detection by key-range sharding across
Resolver processes (SURVEY.md §2.6.2; fdbserver/MasterProxyServer.actor.cpp
:263-316). The JAX package maps the shards onto the devices of a mesh and
combines the commit verdict by psum; the port keeps its single controller
and places an engine's shards in groups, each a contiguous run of shards
stacked on one device (sharding.py): within a group the psum is the
stacked fixpoint's sum over the shard axis, and across groups a leader
device gathers the fixpoint's inputs and launches it once (exchange.py).
"""
from .sharding import Group, KeyShardMap, ShardedConflictEngine, make_sharded_step, placement

__all__ = ["Group", "KeyShardMap", "ShardedConflictEngine", "make_sharded_step", "placement"]
