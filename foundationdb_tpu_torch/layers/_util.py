"""Shared layer plumbing.

Port of ``foundationdb_tpu/layers/_util.py``.
"""
from __future__ import annotations

from typing import List, Tuple


async def read_all(tr, lo: bytes, hi: bytes,
                   page: int = 1000) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) in [lo, hi), paginated — a bare get_range
    silently truncates at the client's default limit, which breaks any
    layer method presenting itself as a COMPLETE read."""
    out: List[Tuple[bytes, bytes]] = []
    cur = lo
    while True:
        rows = await tr.get_range(cur, hi, limit=page)
        out.extend(rows)
        if len(rows) < page:
            return out
        cur = rows[-1][0] + b"\x00"
