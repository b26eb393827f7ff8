"""Container layers: Vector and Set over tuple-packed keys.

Port of ``foundationdb_tpu/layers/containers.py``.

Re-design of layers/containers/{vector.py,set.py}: each container is a
Subspace; elements are individual keys, so every operation is a handful
of point reads/writes and containers of any size never rewrite
themselves. A sparse Vector stores only set indices (size = last index
+ 1, reads of holes return the default), matching the reference
vector's sparse representation."""
from __future__ import annotations

from typing import Any, List, Optional

from ..bindings.fdb_api import Subspace
from ._util import read_all


class Vector:
    """Sparse vector: (index,) -> value under the subspace; size derives
    from the last populated index."""

    def __init__(self, subspace: Subspace, default: bytes = b""):
        self.ss = subspace
        self.default = default

    async def size(self, tr) -> int:
        lo, hi = self.ss.range()
        rows = await tr.get_range(lo, hi, limit=1, reverse=True)
        if not rows:
            return 0
        return self.ss.unpack(rows[0][0])[0] + 1

    async def get(self, tr, index: int) -> bytes:
        v = await tr.get(self.ss.pack((index,)))
        return self.default if v is None else v

    def set(self, tr, index: int, value: bytes) -> None:
        tr.set(self.ss.pack((index,)), value)

    async def push(self, tr, value: bytes) -> int:
        i = await self.size(tr)
        tr.set(self.ss.pack((i,)), value)
        return i

    async def pop(self, tr) -> Optional[bytes]:
        """Remove and return the back element; size shrinks by EXACTLY
        one — when the new back is a hole, the default is materialized
        there so trailing holes don't collapse with it."""
        n = await self.size(tr)
        if n == 0:
            return None
        back = self.ss.pack((n - 1,))
        v = await tr.get(back)
        tr.clear(back)
        if n >= 2:
            new_back = self.ss.pack((n - 2,))
            if await tr.get(new_back) is None:
                tr.set(new_back, self.default)
        return self.default if v is None else v

    async def items(self, tr, max_items: int = 1_000_000) -> List[bytes]:
        """Dense read-out: holes filled with the default. One far-flung
        sparse index implies size() entries of output, so the
        materialized length is capped — raise rather than OOM."""
        n = await self.size(tr)
        if n > max_items:
            raise ValueError(
                f"dense read of {n} logical elements exceeds "
                f"max_items={max_items}; read the sparse keys instead")
        lo, hi = self.ss.range()
        rows = await read_all(tr, lo, hi)
        out: List[bytes] = []
        for k, v in rows:
            i = self.ss.unpack(k)[0]
            out.extend(self.default for _ in range(i - len(out)))
            out.append(v)
        return out


class FdbSet:
    """Unordered set of tuple-encodable members; one key per member."""

    def __init__(self, subspace: Subspace):
        self.ss = subspace

    def add(self, tr, member: Any) -> None:
        tr.set(self.ss.pack((member,)), b"")

    def discard(self, tr, member: Any) -> None:
        tr.clear(self.ss.pack((member,)))

    async def contains(self, tr, member: Any) -> bool:
        return await tr.get(self.ss.pack((member,))) is not None

    async def members(self, tr) -> List[Any]:
        lo, hi = self.ss.range()
        return [self.ss.unpack(k)[0] for k, _v in await read_all(tr, lo, hi)]
