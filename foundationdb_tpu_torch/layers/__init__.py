"""Sample layers: higher-level data models built purely on the
transactional KV API (reference: layers/ — pubsub, bulkload,
containers). Nothing here touches server internals; every structure is
ordinary keys under a Subspace, so they work identically against the
sim cluster and a real one.

Port of ``foundationdb_tpu/layers/__init__.py``.
"""
from ._util import read_all
from .bulkload import bulk_load
from .containers import FdbSet, Vector
from .pubsub import PubSub

__all__ = ["PubSub", "bulk_load", "FdbSet", "Vector", "read_all"]
