"""Master: the commit-version authority.

Port of ``foundationdb_tpu/server/master.py``.

Round-1 scope of masterserver.actor.cpp: getVersion (:786) — monotonically
increasing commit versions advancing ~VERSIONS_PER_SECOND with virtual wall
clock, handed out as (prev_version, version) pairs so resolvers and tlogs
can chain batches into a total order. Per-proxy request_num dedup mirrors
the reference's replyToProxies window. Recovery epochs arrive in a later
round; the seed master starts its epoch at version 1.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

from ..core.knobs import SERVER_KNOBS
from ..core.types import VERSIONS_PER_SECOND, Version
from ..sim.loop import TaskPriority, now
from ..sim.network import SimProcess
from .messages import GetCommitVersionRequest, GetCommitVersionReply

GET_COMMIT_VERSION_TOKEN = "master.getCommitVersion"

#: Replies kept per proxy so a lost-reply repair re-query (by request_num)
#: replays the original version pair even after newer requests landed
#: (reference: lastCommitProxyVersionReplies window, masterserver.actor.cpp).
#: Correctness requires the lost request_num to still be inside the window
#: when the repair re-query lands; the proxy pipelines at most a handful of
#: phase-1 exchanges, and repair fires promptly on failure, so 256 leaves
#: orders of magnitude of headroom. Epoch recovery (which ends the whole
#: chain) is the backstop for anything outside it.
PROXY_REPLY_WINDOW = 256


#: a new epoch's recovery transaction jumps the version chain past the whole
#: MVCC window, so every pre-recovery read snapshot resolves TOO_OLD at the
#: fresh (empty) resolvers instead of silently missing lost conflict history
#: (reference: recoveryTransactionVersion jump, masterserver.actor.cpp:330;
#: applied by MasterServer's recovery transaction, masterserver.py).
RECOVERY_VERSION_JUMP = 2 * 5_000_000


class Master:
    def __init__(self, proc: SimProcess, start_version: Version = 1,
                 token_suffix: str = ""):
        self.proc = proc
        self.version: Version = start_version
        self.last_version_time: float = now()
        self.token = GET_COMMIT_VERSION_TOKEN + token_suffix
        # proxy_id -> {request_num: reply}, trimmed to PROXY_REPLY_WINDOW
        self._proxy_window: Dict[str, "OrderedDict[int, GetCommitVersionReply]"] = {}
        #: live resolutionBalancing flip: (flip_version, old_splits,
        #: new_splits) piggybacked on every version reply — versions below
        #: the flip were all handed out under the old map, versions at or
        #: above it are only ever handed out carrying the new one
        self._routing_flip: tuple = (0, (), ())
        #: future grants never fall below this (armed by a flip): the chain
        #: itself stays exactly the granted-version sequence — a BURNED
        #: version would wedge resolvers waiting when_at_least(prev) on a
        #: version nobody ever resolves
        self._version_floor: Version = 0
        proc.register(self.token, self.get_commit_version)

    def set_routing_flip(self, old_splits: tuple, new_splits: tuple) -> Version:
        """Arm a live resolver-map change: strictly newer than any granted
        version AND any earlier flip (back-to-back flips must not share a
        version — proxies order flips strictly); every later grant jumps to
        at least the flip, so no version in no-man's-land is ever handed
        out under an ambiguous map. Returns the flip version."""
        flip = max(self.version + 1, self._routing_flip[0] + 1)
        self._version_floor = flip
        self._routing_flip = (flip, tuple(old_splits), tuple(new_splits))
        return flip

    def unregister(self) -> None:
        self.proc.unregister(self.token)

    async def get_commit_version(self, req: GetCommitVersionRequest) -> GetCommitVersionReply:
        """reference: getVersion, masterserver.actor.cpp:786-850."""
        window = self._proxy_window.setdefault(req.proxy_id, OrderedDict())
        cached = window.get(req.request_num)
        if cached is not None:
            return cached  # retried request: same version pair
        t = now()
        advance = max(1, int((t - self.last_version_time) * SERVER_KNOBS.versions_per_second))
        prev = self.version
        self.version = max(prev + advance, self._version_floor)
        self.last_version_time = t
        flip, olds, news = self._routing_flip
        reply = GetCommitVersionReply(version=self.version, prev_version=prev,
                                      routing_version=flip,
                                      routing_old_splits=olds,
                                      routing_splits=news)
        window[req.request_num] = reply
        while len(window) > PROXY_REPLY_WINDOW:
            window.popitem(last=False)
        return reply
