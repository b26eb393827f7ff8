"""PubSub layer: feeds, inboxes, fan-in on read.

Port of ``foundationdb_tpu/layers/pubsub.py``.

Re-design of layers/pubsub/pubsub.py (315 LoC): feeds publish an ordered
message log; inboxes subscribe to feeds and read by MERGING the
subscribed logs past a per-feed watermark — messages are written once
(no fan-out amplification on post) and delivery state is one watermark
key per (inbox, feed) edge.

Layout under the layer's subspace:
    ("feed", feed)                        -> b""        (existence)
    ("msg",  feed, seq)                   -> payload
    ("next", feed)                        -> str(seq)   (allocator)
    ("sub",  inbox, feed)                 -> b""        (edge)
    ("mark", inbox, feed)                 -> str(seq)   (read watermark)
    ("rot",  inbox)                       -> feed       (fairness cursor)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..bindings.fdb_api import Subspace
from ._util import read_all


class PubSub:
    def __init__(self, subspace: Optional[Subspace] = None):
        self.ss = subspace if subspace is not None else Subspace((b"pubsub",))

    # -- feeds ---------------------------------------------------------------
    async def create_feed(self, tr, feed: bytes) -> None:
        tr.set(self.ss.pack(("feed", feed)), b"")

    async def post(self, tr, feed: bytes, payload: bytes) -> int:
        """Append to the feed's log; returns the message's sequence."""
        if await tr.get(self.ss.pack(("feed", feed))) is None:
            raise KeyError(f"no such feed: {feed!r}")
        nk = self.ss.pack(("next", feed))
        seq = int(await tr.get(nk) or b"0")
        tr.set(nk, b"%d" % (seq + 1))
        tr.set(self.ss.pack(("msg", feed, seq)), payload)
        return seq

    async def feed_messages(self, tr, feed: bytes,
                            limit: int = 100) -> List[bytes]:
        lo, hi = self.ss.range(("msg", feed))
        return [v for _k, v in await tr.get_range(lo, hi, limit=limit)]

    # -- inboxes -------------------------------------------------------------
    async def subscribe(self, tr, inbox: bytes, feed: bytes) -> None:
        if await tr.get(self.ss.pack(("feed", feed))) is None:
            raise KeyError(f"no such feed: {feed!r}")
        tr.set(self.ss.pack(("sub", inbox, feed)), b"")

    async def unsubscribe(self, tr, inbox: bytes, feed: bytes) -> None:
        tr.clear(self.ss.pack(("sub", inbox, feed)))
        tr.clear(self.ss.pack(("mark", inbox, feed)))

    async def subscriptions(self, tr, inbox: bytes) -> List[bytes]:
        lo, hi = self.ss.range(("sub", inbox))
        return [self.ss.unpack(k)[2] for k, _v in await read_all(tr, lo, hi)]

    async def fetch(self, tr, inbox: bytes,
                    limit: int = 100) -> List[Tuple[bytes, int, bytes]]:
        """Unread (feed, seq, payload) across every subscribed feed,
        advancing each feed's watermark past what was returned. The start
        feed rotates each call so a busy lexicographically-early feed
        can't eat the whole limit forever and starve the rest."""
        feeds = await self.subscriptions(tr, inbox)
        if not feeds:
            return []
        rk = self.ss.pack(("rot", inbox))
        cursor = await tr.get(rk)
        i = feeds.index(cursor) if cursor in feeds else 0
        out: List[Tuple[bytes, int, bytes]] = []
        for feed in feeds[i:] + feeds[:i]:
            mk = self.ss.pack(("mark", inbox, feed))
            mark = int(await tr.get(mk) or b"0")
            lo = self.ss.pack(("msg", feed, mark))
            _, hi = self.ss.range(("msg", feed))
            rows = await tr.get_range(lo, hi, limit=limit - len(out))
            for k, v in rows:
                seq = self.ss.unpack(k)[2]
                out.append((feed, seq, v))
            if rows:
                tr.set(mk, b"%d" % (self.ss.unpack(rows[-1][0])[2] + 1))
            if len(out) >= limit:
                break
        if out:
            # rotate only when something was delivered: an empty poll
            # stays a read-only transaction (no cursor write, no commit)
            tr.set(rk, feeds[(i + 1) % len(feeds)])
        return out
