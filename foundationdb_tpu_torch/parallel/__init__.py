"""Key-range sharded conflict detection: the port of
``foundationdb_tpu/parallel/``.

The reference scales conflict detection by key-range sharding across
Resolver processes (SURVEY.md §2.6.2; fdbserver/MasterProxyServer.actor.cpp
:263-316). The JAX package maps the shards onto the devices of a mesh and
combines the commit verdict by psum; the port keeps its single controller
and runs every shard of an engine on one device, where the psum becomes
the stacked fixpoint's sum over the shard axis (sharding.py).
"""
from .sharding import (DistinctDevicesError, KeyShardMap, ShardedConflictEngine,
                       make_sharded_step)

__all__ = ["DistinctDevicesError", "KeyShardMap", "ShardedConflictEngine",
           "make_sharded_step"]
