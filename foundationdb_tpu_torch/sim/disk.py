"""Simulated disks with kill-time loss of un-fsynced writes.

Port of ``foundationdb_tpu/sim/disk.py``.

Re-design of the reference's IAsyncFile stack for simulation
(fdbrpc/AsyncFileNonDurable.actor.h + SimDiskSpace): every process address
owns a SimDisk of named files that SURVIVES process death and reboot (the
machine's platters), while un-synced writes live in a page-cache buffer
that a crash randomly applies, drops, or tears per write — the fault model
that forces every durable component to reason about fsync boundaries and
torn tails, exactly like the reference's correctness runs.

Latencies are drawn from the simulation RNG so disk scheduling is
deterministic per seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import error
from .loop import Scheduler, TaskPriority


class SimFile:
    """One file: durable bytes + un-synced write buffer (the page cache)."""

    def __init__(self, disk: "SimDisk", name: str):
        self.disk = disk
        self.name = name
        self.durable = bytearray()
        #: ordered un-synced writes: (offset, bytes)
        self.pending: List[Tuple[int, bytes]] = []
        self._pending_truncate: Optional[int] = None

    # -- the OS view (durable + page cache) ----------------------------------
    def _view(self) -> bytearray:
        buf = bytearray(self.durable)
        if self._pending_truncate is not None:
            del buf[self._pending_truncate:]
        for off, data in self.pending:
            if len(buf) < off:
                buf.extend(b"\x00" * (off - len(buf)))
            buf[off:off + len(data)] = data
        return buf

    def size(self) -> int:
        return len(self._view())

    # -- async file API (IAsyncFile) ------------------------------------------
    async def read(self, offset: int, length: int) -> bytes:
        await self.disk._latency()
        view = self._view()
        return bytes(view[offset:offset + length])

    async def write(self, offset: int, data: bytes) -> None:
        await self.disk._latency()
        self.pending.append((offset, bytes(data)))

    async def truncate(self, size: int) -> None:
        await self.disk._latency()
        # Order matters vs pending writes; flatten what we have, then mark.
        flat = self._view()
        del flat[size:]
        self.pending = [(0, bytes(flat))]
        self._pending_truncate = 0

    async def sync(self) -> None:
        """fsync: everything written so far becomes durable."""
        await self.disk._latency(sync=True)
        self.durable = self._view()
        self.pending = []
        self._pending_truncate = None

    # -- crash semantics (AsyncFileNonDurable) --------------------------------
    def crash(self, rng) -> None:
        """Process died with this file open: each un-synced write is
        independently applied, dropped, or torn (random prefix + garbage
        tail) — reference: AsyncFileNonDurable KillMode semantics."""
        buf = bytearray(self.durable)
        if self._pending_truncate is not None:
            del buf[self._pending_truncate:]
        for off, data in self.pending:
            roll = rng.random01()
            if roll < 0.5:
                applied = data                        # made it to the platter
            elif roll < 0.8:
                continue                              # lost entirely
            else:
                keep = rng.random_int(0, len(data) + 1)
                # torn: prefix lands, the rest is garbage bits
                applied = data[:keep] + bytes(
                    rng.random_int(0, 256) for _ in range(len(data) - keep)
                )
            if len(buf) < off:
                buf.extend(b"\x00" * (off - len(buf)))
            buf[off:off + len(applied)] = applied
        self.durable = buf
        self.pending = []
        self._pending_truncate = None


class SimDisk:
    """All files for one process address; survives reboots."""

    def __init__(self, sched: Scheduler, min_latency: float = 0.00005,
                 max_latency: float = 0.0005):
        self.sched = sched
        self.files: Dict[str, SimFile] = {}
        self.min_latency = min_latency
        self.max_latency = max_latency

    async def _latency(self, sync: bool = False):
        r = self.sched.rng.random01()
        lat = self.min_latency + (self.max_latency - self.min_latency) * r
        if sync:
            lat *= 4  # fsync costs more than a buffered write
        f = self.sched.delay(lat, TaskPriority.DEFAULT_DELAY)
        await f

    def open(self, name: str, create: bool = True) -> SimFile:
        f = self.files.get(name)
        if f is None:
            if not create:
                raise error.file_not_found(name)
            f = self.files[name] = SimFile(self, name)
        return f

    def exists(self, name: str) -> bool:
        return name in self.files

    def delete(self, name: str) -> None:
        self.files.pop(name, None)

    def rename(self, src: str, dst: str) -> None:
        """Atomic rename (POSIX semantics; callers sync the source first).
        The sim treats the rename itself as immediately durable."""
        f = self.files.pop(src)
        f.name = dst
        self.files[dst] = f

    def list(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self.files if n.startswith(prefix))

    def crash(self, rng) -> None:
        for f in self.files.values():
            f.crash(rng)
