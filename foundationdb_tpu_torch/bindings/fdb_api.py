"""The `fdb`-shaped binding API: open / @transactional / Subspace.

Port of ``foundationdb_tpu/bindings/fdb_api.py``.

The analog of bindings/python/fdb: the reference's Python binding wraps the
C ABI; here the native client is already in-process, so the binding is the
API-compatibility veneer — the names and calling shapes a reference user
expects (`@fdb.transactional` functions that take `tr` as the first
argument and retry transparently; subspaces that pack typed tuples under a
prefix), adapted to the framework's async runtime.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple

from ..client.database import Database, Transaction
from . import fdb_tuple


def transactional(fn):
    """reference: @fdb.transactional (bindings/python/fdb/impl.py). Wraps
    an async function whose first argument may be a Database or a
    Transaction: given a Database, runs the function in a retry loop and
    commits; given a Transaction, composes into the caller's transaction."""

    @functools.wraps(fn)
    async def wrapper(db_or_tr, *args, **kwargs):
        if isinstance(db_or_tr, Transaction):
            return await fn(db_or_tr, *args, **kwargs)
        db: Database = db_or_tr
        tr = db.create_transaction()
        from ..core import error

        while True:
            try:
                result = await fn(tr, *args, **kwargs)
                await tr.commit()
                return result
            except error.FDBError as e:
                await tr.on_error(e)

    return wrapper


class Subspace:
    """Tuple-packed keys under a byte prefix (bindings' Subspace class)."""

    def __init__(self, prefix_tuple: Sequence[Any] = (), raw_prefix: bytes = b""):
        self.raw_prefix = fdb_tuple.pack(tuple(prefix_tuple), raw_prefix)

    def key(self) -> bytes:
        return self.raw_prefix

    def pack(self, t: Sequence[Any] = ()) -> bytes:
        return fdb_tuple.pack(tuple(t), self.raw_prefix)

    def unpack(self, key: bytes) -> Tuple[Any, ...]:
        return fdb_tuple.unpack(key, self.raw_prefix)

    def range(self, t: Sequence[Any] = ()) -> Tuple[bytes, bytes]:
        return fdb_tuple.range_of(tuple(t), self.raw_prefix)

    def contains(self, key: bytes) -> bool:
        return key.startswith(self.raw_prefix)

    def subspace(self, t: Sequence[Any]) -> "Subspace":
        return Subspace((), self.pack(t))

    def __getitem__(self, item: Any) -> "Subspace":
        return self.subspace((item,))
