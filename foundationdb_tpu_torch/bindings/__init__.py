"""Client binding surface (the analog of bindings/python).

Port of ``foundationdb_tpu/bindings/__init__.py``.

The reference's Python binding wraps libfdb_c with the `fdb` package API:
fdb.open, @fdb.transactional, fdb.tuple, fdb.Subspace. This package offers
the same surface over the native client (client/database.py), so a user of
the reference's Python binding finds the API shapes they expect — async,
because the framework's cooperative runtime is async end to end.
"""
from . import fdb_tuple
from .fdb_api import Database, Subspace, transactional

__all__ = ["Database", "Subspace", "transactional", "fdb_tuple"]
