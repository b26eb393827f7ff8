"""Simulated blob container: the backup target.

Port of ``foundationdb_tpu/backup/container.py``.

The analog of the reference's BlobStore/backup container stack
(fdbrpc/BlobStore.actor.cpp, fdbclient/BackupContainer.actor.cpp) reduced
to a sim-process object store with put/get/list — enough surface for
range-snapshot and mutation-log objects plus a manifest, addressed by
name with prefix listing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..sim.network import SimProcess

PUT_TOKEN = "blob.put"
GET_TOKEN = "blob.get"
LIST_TOKEN = "blob.list"
DELETE_TOKEN = "blob.delete"


@dataclass
class BlobPut:
    name: str
    data: bytes


@dataclass
class BlobGet:
    name: str


@dataclass
class BlobList:
    prefix: str = ""


@dataclass
class BlobDelete:
    name: str


class BlobContainer:
    """One backup container hosted on a sim process."""

    def __init__(self, proc: SimProcess):
        self.proc = proc
        self._objects: Dict[str, bytes] = {}
        proc.register(PUT_TOKEN, self._put)
        proc.register(GET_TOKEN, self._get)
        proc.register(LIST_TOKEN, self._list)
        proc.register(DELETE_TOKEN, self._delete)

    async def _put(self, req: BlobPut) -> None:
        self._objects[req.name] = req.data

    async def _get(self, req: BlobGet) -> Optional[bytes]:
        return self._objects.get(req.name)

    async def _list(self, req: BlobList) -> List[str]:
        return sorted(n for n in self._objects if n.startswith(req.prefix))

    async def _delete(self, req: BlobDelete) -> None:
        self._objects.pop(req.name, None)
