"""The directory layer: hierarchical named namespaces over short prefixes.

Port of ``foundationdb_tpu/bindings/directory.py``.

Re-design of the reference python binding's DirectoryLayer
(bindings/python/fdb/directory_impl.py): paths like ("app", "users") map
to short, unique byte prefixes allocated by a high-contention allocator,
with the path->prefix metadata stored in a node subspace so renames never
move data. Layers (a per-directory type tag) must match on open.

Storage model (mirroring the reference):
  node(prefix)                 = node_subspace[prefix]
  node[SUBDIRS][name]          -> child prefix       (directory tree edges)
  node[b"layer"]               -> layer tag
The root node's "prefix" is the node subspace's own raw prefix.

HighContentionAllocator (directory_impl.py _HighContentionAllocator):
windowed counters + candidate probing. Atomic ADDs keep counter bumps
conflict-free; candidate claims rely on the resolver for uniqueness —
two racing allocators cannot both commit the same candidate because the
claim write conflicts with the other's snapshot read.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from ..core import error
from ..core.types import MutationType
from . import fdb_tuple
from .fdb_api import Subspace

SUBDIRS = 0


class DirectoryError(Exception):
    pass


class HighContentionAllocator:
    def __init__(self, subspace: Subspace):
        self.counters = subspace[0]
        self.recent = subspace[1]

    async def allocate(self, tr) -> bytes:
        """A short byte string never allocated before and never a prefix
        of another allocation (tuple-packed ints have that property
        within a window scheme)."""
        while True:
            # current window start = highest counter key
            rows = await tr.get_range(*self.counters.range(), limit=1, reverse=True,
                                      snapshot=True)
            start = self.counters.unpack(rows[0][0])[0] if rows else 0
            count = struct.unpack("<q", rows[0][1])[0] if rows else 0
            window = self._window_size(start)
            if count * 2 >= window:
                # window exhausted: advance it, clearing superseded state
                start += window
                tr.clear_range(self.counters.pack(()), self.counters.pack((start,)))
                tr.clear_range(self.recent.pack(()), self.recent.pack((start,)))
                window = self._window_size(start)
            tr.atomic_op(self.counters.pack((start,)),
                         struct.pack("<q", 1), MutationType.ADD_VALUE)
            # probe candidates inside the window
            for _ in range(64):
                from ..sim.loop import current_scheduler

                candidate = start + current_scheduler().rng.random_int(0, window)
                key = self.recent.pack((candidate,))
                taken = await tr.get(key)   # conflict range: the claim race
                if taken is None:
                    tr.set(key, b"")
                    return fdb_tuple.pack((candidate,))

    @staticmethod
    def _window_size(start: int) -> int:
        if start < 255:
            return 64
        if start < 65535:
            return 1024
        return 8192


class DirectorySubspace(Subspace):
    """A directory's content subspace plus its identity."""

    def __init__(self, path: Tuple[str, ...], prefix: bytes, layer: bytes,
                 directory_layer: "DirectoryLayer"):
        super().__init__((), prefix)
        self.path = path
        self.layer = layer
        self._dl = directory_layer

    def __repr__(self) -> str:
        return f"DirectorySubspace(path={self.path!r}, prefix={self.raw_prefix!r})"


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = b"\xfe",
                 content_subspace: Optional[Subspace] = None):
        self._node_ss = Subspace((), node_prefix)
        self._content = content_subspace or Subspace((), b"")
        self._alloc = HighContentionAllocator(self._node_ss[b"hca"])
        #: the root directory's node
        self._root_node = self._node_ss.subspace((self._node_ss.raw_prefix,))

    # -- node helpers --------------------------------------------------------
    def _node(self, prefix: bytes) -> Subspace:
        return self._node_ss.subspace((prefix,))

    async def _find(self, tr, path: Sequence[str]):
        """Walk the tree; returns (node, prefix) or (None, None)."""
        node, prefix = self._root_node, self._node_ss.raw_prefix
        for name in path:
            child = await tr.get(node.pack((SUBDIRS, name)))
            if child is None:
                return None, None
            prefix = child
            node = self._node(prefix)
        return node, prefix

    async def _layer_of(self, tr, node: Subspace) -> bytes:
        return (await tr.get(node.pack((b"layer",)))) or b""

    # -- public api ----------------------------------------------------------
    async def create_or_open(self, tr, path: Sequence[str], layer: bytes = b"") -> DirectorySubspace:
        return await self._create_or_open(tr, tuple(path), layer,
                                          allow_create=True, allow_open=True)

    async def create(self, tr, path: Sequence[str], layer: bytes = b"") -> DirectorySubspace:
        return await self._create_or_open(tr, tuple(path), layer,
                                          allow_create=True, allow_open=False)

    async def open(self, tr, path: Sequence[str], layer: bytes = b"") -> DirectorySubspace:
        return await self._create_or_open(tr, tuple(path), layer,
                                          allow_create=False, allow_open=True)

    async def _create_or_open(self, tr, path, layer, allow_create, allow_open):
        if not path:
            raise DirectoryError("the root directory cannot be opened")
        node, prefix = await self._find(tr, path)
        if node is not None:
            if not allow_open:
                raise DirectoryError(f"directory {path!r} already exists")
            existing = await self._layer_of(tr, node)
            if layer and existing != layer:
                raise DirectoryError(
                    f"layer mismatch at {path!r}: {existing!r} != {layer!r}")
            return DirectorySubspace(path, prefix, existing, self)
        if not allow_create:
            raise DirectoryError(f"directory {path!r} does not exist")
        # create parents, then allocate this directory's prefix
        if len(path) > 1:
            parent = await self._create_or_open(tr, path[:-1], b"",
                                               allow_create=True, allow_open=True)
            parent_node = self._node(parent.raw_prefix)
        else:
            parent_node = self._root_node
        prefix = self._content.raw_prefix + await self._alloc.allocate(tr)
        node = self._node(prefix)
        tr.set(parent_node.pack((SUBDIRS, path[-1])), prefix)
        tr.set(node.pack((b"layer",)), layer)
        return DirectorySubspace(tuple(path), prefix, layer, self)

    async def list(self, tr, path: Sequence[str] = ()) -> List[str]:
        if path:
            node, _prefix = await self._find(tr, path)
            if node is None:
                raise DirectoryError(f"directory {tuple(path)!r} does not exist")
        else:
            node = self._root_node
        lo, hi = node.range((SUBDIRS,))
        return [node.unpack(k)[1] for k, _v in await tr.get_range(lo, hi)]

    async def exists(self, tr, path: Sequence[str]) -> bool:
        node, _ = await self._find(tr, path)
        return node is not None

    async def move(self, tr, old_path: Sequence[str], new_path: Sequence[str]) -> DirectorySubspace:
        """Re-link the node under a new parent/name; data never moves
        (the whole point of the prefix indirection)."""
        old_path, new_path = tuple(old_path), tuple(new_path)
        if new_path[:len(old_path)] == old_path:
            raise DirectoryError("cannot move a directory into itself")
        node, prefix = await self._find(tr, old_path)
        if node is None:
            raise DirectoryError(f"directory {old_path!r} does not exist")
        if await self._find(tr, new_path) != (None, None):
            raise DirectoryError(f"directory {new_path!r} already exists")
        if len(new_path) > 1:
            parent_node, _p = await self._find(tr, new_path[:-1])
            if parent_node is None:
                raise DirectoryError(f"parent {new_path[:-1]!r} does not exist")
        else:
            parent_node = self._root_node
        if len(old_path) > 1:
            old_parent, _p = await self._find(tr, old_path[:-1])
        else:
            old_parent = self._root_node
        tr.clear(old_parent.pack((SUBDIRS, old_path[-1])))
        tr.set(parent_node.pack((SUBDIRS, new_path[-1])), prefix)
        return DirectorySubspace(new_path, prefix,
                                 await self._layer_of(tr, node), self)

    async def remove(self, tr, path: Sequence[str]) -> bool:
        """Remove the directory, its subtree and ALL its contents."""
        path = tuple(path)
        node, prefix = await self._find(tr, path)
        if node is None:
            return False
        await self._remove_recursive(tr, node, prefix)
        if len(path) > 1:
            parent, _p = await self._find(tr, path[:-1])
        else:
            parent = self._root_node
        tr.clear(parent.pack((SUBDIRS, path[-1])))
        return True

    async def _remove_recursive(self, tr, node: Subspace, prefix: bytes) -> None:
        from ..core.types import strinc

        lo, hi = node.range((SUBDIRS,))
        for _k, child_prefix in await tr.get_range(lo, hi):
            await self._remove_recursive(tr, self._node(child_prefix), child_prefix)
        # contents + metadata (strinc: EVERY key under the prefix, including
        # ones whose next byte is 0xff)
        tr.clear_range(prefix, strinc(prefix))
        nlo, nhi = node.range()
        tr.clear_range(nlo, nhi)
