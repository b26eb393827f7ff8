"""ManagementAPI: transactional database configuration.

Port of ``foundationdb_tpu/server/management.py``.

Re-design of fdbclient/ManagementAPI.actor.cpp (changeConfig) +
DatabaseConfiguration.cpp: the configuration lives in the `\\xff/conf/`
keyspace, written transactionally (ordered with user traffic, replicated,
recovered like any data). The serving master watches the range; a change
updates the coordinated state's conf mirror and bounces the epoch, and
the NEXT recovery recruits with the new counts — exactly the reference's
"most configuration changes take effect at the next recovery" model.
Storage replication changes additionally drive the DD replication fixer,
which grows/shrinks every shard's team to the configured factor.

Conf keys (values are ascii integers):
    \\xff/conf/proxies          commit proxies per generation
    \\xff/conf/resolvers        resolvers (key-shard count)
    \\xff/conf/logs             tlog replicas per generation
    \\xff/conf/log_replication  per-tag tlog replication factor (0 = all)
    \\xff/conf/replication      storage replicas per shard (1/2/3 =
                                single/double/triple)
"""
from __future__ import annotations

from typing import Dict, Optional

CONF_PREFIX = b"\xff/conf/"
CONF_END = CONF_PREFIX + b"\xff"

#: `configure single|double|triple` redundancy modes -> storage replication
REDUNDANCY_MODES = {"single": 1, "double": 2, "triple": 3}
#: every legal conf key suffix
CONF_KEYS = (b"proxies", b"resolvers", b"logs", b"log_replication",
             b"replication")


def conf_key(name: bytes) -> bytes:
    return CONF_PREFIX + name


def conf_int(conf: Dict[bytes, bytes], name: bytes, default: int) -> int:
    """A conf entry as an int, else `default` (missing or unparsable —
    tolerant: a bad write must never wedge recovery)."""
    raw = conf.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


async def read_configuration(tr) -> Dict[bytes, bytes]:
    """The current \\xff/conf/ map through a transaction."""
    rows = await tr.get_range(CONF_PREFIX, CONF_END, limit=1000, snapshot=True)
    return {k[len(CONF_PREFIX):]: v for k, v in rows}


async def change_configuration(db, mode: Optional[str] = None, **counts) -> None:
    """reference: changeConfig. `mode` is a redundancy keyword
    (single/double/triple); `counts` are proxies=/resolvers=/logs=/
    log_replication= integers. Writes are one transaction: the serving
    master's conf watcher picks the commit up and applies it at the next
    recovery."""
    updates: Dict[bytes, bytes] = {}
    if mode is not None:
        if mode not in REDUNDANCY_MODES:
            from ..core import error

            raise error.client_invalid_operation(f"unknown redundancy mode {mode!r}")
        updates[b"replication"] = str(REDUNDANCY_MODES[mode]).encode()
    for name, value in counts.items():
        key = name.encode()
        if key not in CONF_KEYS:
            from ..core import error

            raise error.client_invalid_operation(f"unknown configuration key {name!r}")
        updates[key] = str(int(value)).encode()

    async def go(tr):
        tr.set_access_system_keys()
        for k, v in updates.items():
            tr.set(conf_key(k), v)
    await db.run(go)
