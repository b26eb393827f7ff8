"""DiskQueue: a checksummed durable append log with torn-tail recovery.

Port of ``foundationdb_tpu/server/disk_queue.py``.

Re-design of fdbserver/DiskQueue.actor.cpp: the write-ahead structure under
the tlog and the memory storage engine. One file holds a dual-slot header
page followed by framed entries [length u32][crc32 u32][payload]. A crash
can tear any un-synced write (sim/disk.py crash semantics), so:

  * recovery scans frames from the front and stops at the first bad one —
    everything before was covered by an fsync ack, everything after was
    never acknowledged to anyone;
  * the pop cursor is written to ALTERNATING header slots with a sequence
    number, so a torn header write loses at most the newest pop (re-serving
    acknowledged entries is safe; losing the whole queue is not);
  * compaction builds a fresh file and renames it over the old one — a
    crash on either side of the rename leaves one complete file.

Offsets handed to callers are LOGICAL and monotone for the queue's
lifetime; compaction preserves them (the reference achieves the same with
its paired-file location scheme).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

from ..core import buggify
from ..sim.actors import AsyncMutex
from ..sim.disk import SimDisk, SimFile

#: frame = [length u32][crc u32][payload]; the crc covers the frame's
#: logical START position + length + payload, so zero-filled gaps (a lost
#: write followed by an applied one pads with zeros) can never parse as a
#: valid empty frame (crc32(b"") == 0), and a frame replayed at the wrong
#: position is rejected — the reference gets the same from its page
#: sequence numbers.
_FRAME = struct.Struct("<II")


def _frame_crc(position: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack("<QI", position, len(payload))))
_SLOT = struct.Struct("<QQQI")     # seq, begin logical, base logical, crc32
SLOT_SIZE = 32                     # _SLOT.size (28) padded
HEADER_SIZE = 2 * SLOT_SIZE


class DiskQueue:
    def __init__(self, disk: SimDisk, name: str):
        self.disk = disk
        self.name = name
        #: serializes push/commit/pop/compact: a frame pushed while a
        #: compaction rewrites the file would land in the orphaned old file
        #: and be lost after the rename despite an fsync ack (round-2 review)
        self._mutex = AsyncMutex()
        self.data: SimFile = disk.open(f"{name}.dq")
        self._seq = 0            # header write sequence
        self._base = 0           # logical offset of physical HEADER_SIZE
        self._begin = 0          # logical front (popped boundary)
        self._end = 0            # logical append position

    # -- header slots ----------------------------------------------------------
    def _pack_slot(self) -> bytes:
        body = struct.pack("<QQQ", self._seq, self._begin, self._base)
        return body + struct.pack("<I", zlib.crc32(body)) + b"\x00" * (SLOT_SIZE - _SLOT.size)

    @staticmethod
    def _parse_slot(raw: bytes):
        if len(raw) < _SLOT.size:
            return None
        seq, begin, base, crc = _SLOT.unpack(raw[:_SLOT.size])
        if crc != zlib.crc32(raw[:24]):
            return None
        return seq, begin, base

    async def _write_header(self) -> None:
        self._seq += 1
        slot = self._seq % 2
        await self.data.write(slot * SLOT_SIZE, self._pack_slot())
        await self.data.sync()

    # -- recovery --------------------------------------------------------------
    async def recover(self) -> List[Tuple[int, bytes]]:
        """Scan surviving frames; returns [(logical_end_offset, payload)] in
        append order for entries past the popped front. A torn or partial
        frame ends the scan (nothing past it was ever acked)."""
        raw = await self.data.read(0, self.data.size())
        best = None
        for slot in (0, 1):
            parsed = self._parse_slot(bytes(raw[slot * SLOT_SIZE:(slot + 1) * SLOT_SIZE]))
            if parsed is not None and (best is None or parsed[0] > best[0]):
                best = parsed
        if best is not None:
            self._seq, self._begin, self._base = best
        else:
            self._seq = self._begin = self._base = 0
            if len(raw) < HEADER_SIZE:
                # Fresh queue: lay down both header slots.
                await self.data.truncate(0)
                await self.data.write(0, self._pack_slot() + self._pack_slot())
                await self.data.sync()
                self._end = 0
                return []
        out: List[Tuple[int, bytes]] = []
        off = HEADER_SIZE
        while off + _FRAME.size <= len(raw):
            length, crc = _FRAME.unpack(raw[off:off + _FRAME.size])
            payload = raw[off + _FRAME.size: off + _FRAME.size + length]
            logical_start = self._base + (off - HEADER_SIZE)
            if len(payload) < length or _frame_crc(logical_start, bytes(payload)) != crc:
                break  # torn tail
            off += _FRAME.size + length
            logical_end = self._base + (off - HEADER_SIZE)
            if logical_end > self._begin:
                out.append((logical_end, bytes(payload)))
        self._end = self._base + (off - HEADER_SIZE)
        return out

    # -- append ----------------------------------------------------------------
    async def push(self, payload: bytes) -> int:
        """Buffered append; returns the entry's logical end offset (pass to
        pop_to once consumed downstream). Durable only after commit()."""
        async with self._mutex:
            frame = _FRAME.pack(len(payload), _frame_crc(self._end, payload)) + payload
            off = HEADER_SIZE + (self._end - self._base)
            if buggify.buggify():
                # write split across two page-cache entries: a crash can
                # tear between them — recovery's frame crc must catch it
                mid = len(frame) // 2
                await self.data.write(off, frame[:mid])
                await self.data.write(off + mid, frame[mid:])
            else:
                await self.data.write(off, frame)
            self._end += len(frame)
            return self._end

    async def commit(self) -> None:
        """fsync the appended frames (the ack boundary)."""
        if buggify.buggify():
            # slow fsync: stretches the pre-ack window other failures race
            from ..sim.loop import TaskPriority, delay
            await delay(0.02, TaskPriority.DEFAULT_DELAY)
        async with self._mutex:
            await self.data.sync()

    # -- pop / compaction ------------------------------------------------------
    async def pop_to(self, logical_offset: int) -> None:
        if logical_offset <= self._begin:
            return
        async with self._mutex:
            self._begin = min(max(logical_offset, self._begin), self._end)
            await self._write_header()
            compact_at = (1 << 10) if buggify.buggify() else (1 << 16)
            if (self._begin - self._base) > compact_at and \
                    (self._begin - self._base) * 2 > (self._end - self._base):
                await self._compact()

    async def _compact(self) -> None:
        live = await self.data.read(
            HEADER_SIZE + (self._begin - self._base), self._end - self._begin
        )
        self._base = self._begin
        tmp_name = f"{self.name}.dq.tmp"
        tmp = self.disk.open(tmp_name)
        await tmp.truncate(0)
        await tmp.write(0, self._pack_slot() + self._pack_slot() + bytes(live))
        await tmp.sync()
        self.disk.rename(tmp_name, f"{self.name}.dq")
        self.data = self.disk.open(f"{self.name}.dq")

    @property
    def end_offset(self) -> int:
        return self._end
