"""Client library.

Port of ``foundationdb_tpu/client/__init__.py``.

The analog of fdbclient/NativeAPI + the ReadYourWrites layer, exposing the
reference's transaction API shape: get / get_range / set / clear /
atomic_op / commit / on_error with automatic retry via `Database.run`.
"""
from .database import Database, Transaction

__all__ = ["Database", "Transaction"]
