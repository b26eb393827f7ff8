"""The `\\xff` system keyspace: cluster metadata as ordinary keys.

Port of ``foundationdb_tpu/server/system_keys.py``.

Re-design of fdbclient/SystemData.cpp + fdbserver/ApplyMetadataMutation.h
round-3 scope: shard assignment lives at `\\xff/keyServers/<shard begin>`
and is changed by REAL transactions. The committing proxy copies every
committed system-key mutation into the METADATA_TAG stream of the log
system (the analog of the reference's txnState tag feeding every proxy's
txnStateStore via ApplyMetadataMutation); all proxies drain that stream
up to their batch's prev_version before tagging mutations, which is exact
because commit versions form a single global chain.

Values are wire-encoded dicts, not flat tuples, because the sim's wire
format is the repo-wide stand-in (core/wire.py) — the versioned flat
encoding replaces it at the disk boundary.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import wire
from ..core.types import Key

SYSTEM_PREFIX = b"\xff"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
#: holds wire({"tag": <backup tag>}) while a backup is running; proxies
#: copy every committed user mutation into that log tag (the reference's
#: backup mutation ranges through ApplyMetadataMutation)
BACKUP_ACTIVE_KEY = b"\xff/backup/active"
BACKUP_SEQ_KEY = b"\xff/backup/seq"
#: non-empty value = database locked: proxies reject user commits with
#: database_locked; lock-aware (system) transactions pass — the
#: lockDatabase mechanism DR switchover fences with (reference:
#: fdbclient/ManagementAPI.actor.cpp lockDatabase, \xff/dbLocked)
DB_LOCK_KEY = b"\xff/dbLocked"

#: the log-system tag carrying committed system-key mutations to every
#: proxy (the reference's txsTag, TagPartitionedLogSystem.actor.cpp)
METADATA_TAG = -1
#: backup tags count downward from here, one per backup generation
FIRST_BACKUP_TAG = -2


def encode_backup_active(tag: int) -> bytes:
    return wire.dumps({"tag": tag})


def decode_backup_active(value: bytes) -> Optional[int]:
    if not value:
        return None
    return wire.loads(value).get("tag")


def is_system_key(key: Key) -> bool:
    return key.startswith(SYSTEM_PREFIX)


def key_servers_key(shard_begin: Key) -> Key:
    return KEY_SERVERS_PREFIX + shard_begin


def shard_begin_of(key: Key) -> Key:
    assert key.startswith(KEY_SERVERS_PREFIX)
    return key[len(KEY_SERVERS_PREFIX):]


def encode_key_servers(team: List[Tuple[int, str]],
                       extra_tags: Tuple[int, ...] = ()) -> bytes:
    """`team` serves reads and receives writes; `extra_tags` additionally
    receive writes (the destination replicas of an in-flight shard move —
    MoveKeys' old+new keyServers value, MoveKeys.actor.cpp:821)."""
    return wire.dumps({"team": [tuple(m) for m in team],
                      "extra_tags": tuple(extra_tags)})


def decode_key_servers(value: bytes) -> Tuple[List[Tuple[int, str]], Tuple[int, ...]]:
    d = wire.loads(value)
    return [tuple(m) for m in d["team"]], tuple(d.get("extra_tags", ()))
