"""Proxy: the transaction front door.

Port of ``foundationdb_tpu/server/proxy.py``.

Re-design of fdbserver/MasterProxyServer.actor.cpp round-1 scope:

  * GRV path: requests batch over a short interval and are answered with the
    proxy's committed version (queueTransactionStartRequests:113,
    transactionStarter:947; ratekeeper admission arrives in a later round).
  * Commit path: commitBatch:319's five phases, pipelined across batches via
    two NotifiedVersion tokens exactly like the reference's
    latestLocalCommitBatchResolving/Logging (:362-364,414-415,424-426,
    800-803): batch N+1 may fetch its commit version while batch N resolves,
    and may resolve while N logs — but version-order is preserved at the
    resolver and tlog by (prev_version -> version) chaining.
  * Key-range sharding of resolution: each transaction's conflict ranges are
    split/clipped across resolvers by the static resolver shard map
    (ResolutionRequestBuilder::addTransaction:263-316); every touched
    resolver must vote COMMITTED; votes combine with min (:489-500). Every
    resolver receives every batch (possibly with zero transactions) so its
    version chain never stalls.
  * Serves GetKeyServerLocationsRequest from the static storage shard map
    (readRequestServer:1058).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core import buggify, error
from ..core.knobs import SERVER_KNOBS
from ..core.stats import CounterCollection
from ..core.trace import g_spans, span_event, span_now
from ..core.types import (
    CommitTransaction,
    Key,
    KeyRange,
    Mutation,
    MutationType,
    TransactionCommitResult,
    VERSIONSTAMP_MUTATIONS,
    Version,
    transform_versionstamp_mutation,
)
from ..core.keyshard import KeyShardMap
from ..sim.actors import ActorCollection, NotifiedVersion, PromiseStream, all_of, any_of
from ..sim.loop import Future, Promise, TaskPriority, delay, spawn
from ..sim.network import Endpoint, SimProcess
from .log_system import LogSystemClient, LogSystemConfig
from .system_keys import (
    BACKUP_ACTIVE_KEY,
    DB_LOCK_KEY,
    KEY_SERVERS_PREFIX,
    METADATA_TAG,
    decode_backup_active,
    decode_key_servers,
    is_system_key,
    shard_begin_of,
)
from .messages import (
    CommitReply,
    CommitTransactionRequest,
    GetCommitVersionRequest,
    GetKeyServerLocationsReply,
    GetKeyServerLocationsRequest,
    GetReadVersionReply,
    GetReadVersionRequest,
    ResolveTransactionBatchReply,
    ResolveTransactionBatchRequest,
)

GRV_TOKEN = "proxy.getReadVersion"
COMMIT_TOKEN = "proxy.commit"
LOCATIONS_TOKEN = "proxy.getKeyServerLocations"
STATS_TOKEN = "proxy.stats"
COMMITTED_VERSION_TOKEN = "proxy.committedVersion"
METADATA_VERSION_TOKEN = "proxy.metadataVersion"

#: batching intervals/caps come from the knob registry so BUGGIFY can
#: randomize them per simulation (reference: START_TRANSACTION_BATCH_* /
#: COMMIT_TRANSACTION_BATCH_* knobs, fdbserver/Knobs.cpp)
MAX_COMMIT_BATCH = 512
#: verdict sentinel: committed by the resolvers but rejected by the
#: database lock (never a TransactionCommitResult value)
_VERDICT_LOCKED = -2
#: empty-batch tick when idle (reference: the commitBatcher's max interval)
IDLE_COMMIT_INTERVAL = 0.5
#: reply timeout on proxy->master/resolver/tlog requests: an alive-but-
#: partitioned peer must fail the batch (commit_unknown_result + repair)
#: rather than wedge the pipeline forever (round-2 review finding).
SERVER_REQUEST_TIMEOUT = 5.0

_TLOG_STOPPED = error.tlog_stopped("").code


class RoutingState:
    """Mutable shard routing: the seed teams from ProxyConfig plus every
    applied `\\xff/keyServers/` mutation (ApplyMetadataMutation's effect on
    the proxy's keyServers cache). Whole-shard granularity: a keyServers
    key must name an existing shard begin."""

    def __init__(self, shards: KeyShardMap, teams):
        # private copy: splits/merges mutate the boundary list in place
        self.shards = KeyShardMap(list(shards.begins[1:]))
        self.teams = [list(t) for t in teams]
        self.extra_tags: List[tuple] = [() for _ in self.teams]
        #: live backup's log tag (None = no backup running)
        self.backup_tag: Optional[int] = None
        #: database lock (lockDatabase / DR switchover fence): user commits
        #: are rejected while set; lock-aware transactions pass
        self.db_locked = False

    def write_tags(self, s: int) -> List[int]:
        return [t for t, _a in self.teams[s]] + list(self.extra_tags[s])

    def addrs(self, s: int) -> List[str]:
        return [a for _t, a in self.teams[s]]

    def apply_mutation(self, m: Mutation) -> None:
        if m.type != MutationType.SET_VALUE:
            return
        if m.param1 == BACKUP_ACTIVE_KEY:
            self.backup_tag = decode_backup_active(m.param2)
            return
        if m.param1 == DB_LOCK_KEY:
            self.db_locked = m.param2 != b""
            return
        if not m.param1.startswith(KEY_SERVERS_PREFIX):
            return
        begin = shard_begin_of(m.param1)
        s = self.shards.shard_of_key(begin) if begin else 0
        team, extra = decode_key_servers(m.param2)
        if self.shards.begins[s] == begin:
            if not team:
                # boundary removal (DD merge): [begin, next) joins the
                # PREDECESSOR shard, whose team already absorbed the data
                if s > 0:
                    del self.shards.begins[s]
                    self.shards.n_shards -= 1
                    del self.teams[s]
                    del self.extra_tags[s]
                return
            self.teams[s] = list(team)
            self.extra_tags[s] = tuple(extra)
            return
        if not team:
            return
        # new boundary inside shard s (DD split): [begin, old_next) gets the
        # value's team; the lower part keeps shard s's current team
        self.shards.begins.insert(s + 1, begin)
        self.shards.n_shards += 1
        self.teams.insert(s + 1, list(team))
        self.extra_tags.insert(s + 1, tuple(extra))


def teams_from_storage_tags(storage_tags):
    """Group flat (tag, begin, end, addr) server records into the shard map
    + per-shard replica teams (servers with an identical range form a
    team). The inverse of the master's seed loop; also used wherever a
    persisted DBCoreState.storage_tags must become routing state."""
    by_range: Dict[Tuple[Key, Key], List[Tuple[int, str]]] = {}
    for tag, b, e, addr in storage_tags:
        by_range.setdefault((b, e), []).append((tag, addr))
    ordered = sorted(by_range.items(), key=lambda kv: kv[0][0])
    assert ordered and ordered[0][0][0] == b"", "shard map must start at ''"
    shard_map = KeyShardMap([b for (b, _e), _m in ordered[1:]])
    teams = [sorted(members) for (_rng, members) in ordered]
    return shard_map, teams


@dataclass
class ProxyConfig:
    """Wiring for one proxy of one generation: the master and resolvers are
    endpoint-addressed (tokens carry the generation suffix so a stale proxy
    can never reach a newer generation's roles), and commits flow through
    the replicated log system rather than a single tlog."""

    master_ep: Endpoint
    resolver_eps: List[Endpoint]
    resolver_shards: KeyShardMap
    log_config: LogSystemConfig
    #: per shard: the replica team [(tag, address), ...] — every member
    #: stores the shard (DataDistribution's keyServers reduced to a static
    #: team map; tags address tlog streams, one per storage server)
    storage_teams: List[List[Tuple[int, str]]]
    storage_shards: KeyShardMap
    #: the master's role-scoped wait-failure endpoint; the proxy watches it
    #: and shuts down when the master dies (its generation is over)
    master_wf_ep: Optional[Endpoint] = None
    #: ratekeeper endpoint (GetRateInfo); None = unthrottled
    rate_ep: Optional[Endpoint] = None
    #: committed-version endpoints of EVERY proxy in this generation
    #: (including this one); GRVs confirm the max committed version across
    #: all of them (getLiveCommittedVersion, MasterProxyServer.actor.cpp:897)
    peer_grv_eps: List[Endpoint] = field(default_factory=list)
    #: transactions per commit batch (None = MAX_COMMIT_BATCH); a pipelined
    #: resolver is fed batches sized to its compiled kernel shape T
    max_commit_batch: Optional[int] = None
    #: in-flight commit window (None = unbounded, today's behavior): at
    #: most this many batches between dispatch and fully-logged. While the
    #: window is full the batcher KEEPS ACCUMULATING arrivals, so resolver
    #: backpressure turns into larger batches — the feed a multi-batch
    #: in-flight resolver pipeline needs — instead of a deeper queue of
    #: tiny batches stalled at the version chain. Size it to the resolver
    #: pipeline depth + 1 (one batch accumulating, `depth` in service).
    commit_pipeline_window: Optional[int] = None
    #: per-tenant admission control (server/ratekeeper.py TenantAdmission;
    #: docs/real_cluster.md): None = off (every request rides the legacy
    #: path). Set, commits carrying a tenant id are token-bucket gated on
    #: the ratekeeper-published rate — one hot tenant sheds as fast typed
    #: transaction_throttled errors instead of queueing every tenant
    tenant_admission: Optional[object] = None


class Proxy:
    def __init__(self, proc: SimProcess, net, cfg: ProxyConfig, start_version: Version = 1):
        self.proc = proc
        self.net = net
        self.cfg = cfg
        self.log = LogSystemClient(net, proc.address, cfg.log_config,
                                   push_timeout=SERVER_REQUEST_TIMEOUT)
        self.committed_version = NotifiedVersion(start_version)
        self.batch_resolving = NotifiedVersion(0)
        self.batch_logging = NotifiedVersion(0)
        self._batch_num = 0
        self._request_num = 0
        #: bn -> (prev_version, version) for batches whose version is taken
        #: from the master but not yet durably chained (crash repair)
        self._batch_versions: Dict[int, Tuple[Version, Version]] = {}
        #: bn -> tagged messages, stashed once a push is ATTEMPTED: a failed
        #: push may have landed on some tlog replicas, so repair must re-push
        #: the identical payload (replicas dedupe by version) — an empty
        #: repair would leave the replicas of one version divergent
        self._batch_messages: Dict[int, Dict[int, List[Mutation]]] = {}
        #: bn -> master request_num for batches whose GetCommitVersion request
        #: is in flight; a lost reply may still have advanced the master's
        #: chain, so repair must re-query by request_num (the master's
        #: per-proxy dedup window replays the same version pair)
        self._pending_master_req: Dict[int, int] = {}
        self._grv_waiters: List[Promise] = []
        self._grv_flush_active = False
        #: dynamic shard routing (seed + applied keyServers metadata)
        self.routing = RoutingState(cfg.storage_shards, cfg.storage_teams)
        #: live resolutionBalancing flips, version-ascending: (flip_version,
        #: old_splits, new_splits) learned from the master's version
        #: replies. A batch splits by the newest flip at or below its
        #: commit version (never the single latest: with back-to-back
        #: flips, a batch between them must use the FIRST flip's map)
        self._routing_flips: List[tuple] = []
        #: metadata stream drained through this version (system_keys.py)
        self._metadata_version = start_version
        self._last_batch_time = 0.0
        self._commit_queue: PromiseStream = PromiseStream()
        #: reference: ProxyStats (MasterProxyServer.actor.cpp:48-80);
        #: counters ALSO feed the per-process TDMetric time-series, which
        #: a MetricLogger can persist into \xff/metrics/
        from ..core.tdmetric import TDMetricCollection
        from ..sim.loop import now as _sim_now

        self.tdmetrics = TDMetricCollection(now=_sim_now)
        self.stats = CounterCollection("Proxy", proc.address,
                                       tdmetrics=self.tdmetrics)
        #: ratekeeper admission (transactionStarter:947): GRVs are released
        #: from a budget replenished at tps_limit per second
        self._tps_limit: float = float("inf")
        #: adaptive commit-batch cap relayed from the resolvers' budget
        #: batchers through the ratekeeper (GetRateInfoReply); None =
        #: static cfg.max_commit_batch sizing only
        self._commit_batch_target: Optional[int] = None
        self._grv_budget: float = 0.0
        self._grv_budget_t: float = 0.0
        self._dead = False
        #: conflict-aware admission scheduling (pipeline/scheduler.py),
        #: knob-gated hard off by default (`resolver_sched`): between the
        #: dynamic batcher and dispatch, the scheduler may pre-abort
        #: predicted-doomed commits, capture hot-range writers into
        #: serialization lanes, and defer separation losers into
        #: `_sched_carry` (consumed ahead of the next batch's arrivals)
        from ..pipeline.scheduler import ConflictScheduler, SchedConfig

        self.conflict_sched = ConflictScheduler(
            SchedConfig.from_knobs(), entry_txn=lambda e: e[0])
        self._sched_carry: List[Tuple[CommitTransaction, Promise]] = []
        #: proxy-owned tasks: cancelled on shutdown() without touching other
        #: roles hosted by the same worker process
        self.actors = ActorCollection()
        proc.register(GRV_TOKEN, self.get_read_version)
        proc.register(COMMIT_TOKEN, self.commit)
        proc.register(LOCATIONS_TOKEN, self.get_key_server_locations)
        proc.register(STATS_TOKEN, self._stats_req)
        proc.register(COMMITTED_VERSION_TOKEN, self._committed_version_req)
        proc.register(METADATA_VERSION_TOKEN, self._metadata_version_req)
        self._spawn(self.commit_batcher(), TaskPriority.PROXY_COMMIT_BATCHER, "commitBatcher")
        self._spawn(self.idle_committer(), TaskPriority.PROXY_COMMIT_BATCHER, "idleCommitter")
        self._spawn(self.stats.run_logger(), TaskPriority.PROXY_GRV_TIMER, "proxyStats")
        if cfg.master_wf_ep is not None:
            self._spawn(self._watch_master(), TaskPriority.FAILURE_MONITOR, "watchMaster")
        if cfg.rate_ep is not None:
            self._spawn(self._rate_fetcher(), TaskPriority.RATEKEEPER, "rateFetcher")

    async def _rate_fetcher(self) -> None:
        """Fetch the admission rate (getRate loop,
        MasterProxyServer.actor.cpp:86); a stale limit is kept on errors."""
        from .ratekeeper import GetRateInfoRequest

        while True:
            try:
                reply = await self.net.request(
                    self.proc.address, self.cfg.rate_ep,
                    GetRateInfoRequest(self.proc.address),
                    TaskPriority.RATEKEEPER, timeout=1.0,
                )
                self._tps_limit = reply.tps_limit
                self._commit_batch_target = getattr(
                    reply, "commit_batch_target", None)
                if self.cfg.tenant_admission is not None:
                    # the same published rate that meters GRV release also
                    # feeds the per-tenant commit admission buckets
                    self.cfg.tenant_admission.set_rate(reply.tps_limit)
            except error.FDBError:
                pass
            await delay(SERVER_KNOBS.ratekeeper_update_interval, TaskPriority.RATEKEEPER)

    def _replenish_grv_budget(self) -> None:
        from ..sim.loop import now

        t = now()
        if self._tps_limit == float("inf"):
            self._grv_budget = float("inf")
        else:
            dt = max(0.0, t - self._grv_budget_t)
            if self._grv_budget == float("inf"):
                self._grv_budget = 0.0
            # cap the burst at ~100ms of budget (reference: the smoothed
            # release window in transactionStarter)
            self._grv_budget = min(self._grv_budget + self._tps_limit * dt,
                                   max(1.0, self._tps_limit * 0.1))
        self._grv_budget_t = t

    async def _watch_master(self) -> None:
        """The master's death ends this generation: stop serving
        (reference: proxies monitor masterLifetime through ServerDBInfo)."""
        from .wait_failure import wait_failure_client

        await wait_failure_client(self.net, self.proc.address, self.cfg.master_wf_ep)
        self.shutdown()

    def _spawn(self, coro, priority, name):
        t = spawn(coro, priority, name=name)
        self.proc.actors.add(t)
        self.actors.add(t)
        return t

    def shutdown(self) -> None:
        """This generation is over (epoch ended by a successor, or the role
        was replaced): stop serving, cancel proxy-owned actors. In-flight
        clients get commit_unknown_result via cancellation/broken futures —
        the honest answer, since the successor generation decides which of
        our versions survived."""
        if self._dead:
            return
        self._dead = True
        for tok in (GRV_TOKEN, COMMIT_TOKEN, LOCATIONS_TOKEN, STATS_TOKEN,
                    COMMITTED_VERSION_TOKEN, METADATA_VERSION_TOKEN):
            self.proc.unregister(tok)
        # laned/carried commits this generation will never dispatch: the
        # successor decides nothing about them, so the honest answer is
        # the same broken-promise path every other queued commit gets
        for _t, pr in self.conflict_sched.flush() + self._sched_carry:
            if not pr.is_set:
                pr.send_error(error.commit_unknown_result("proxy shutdown"))
        self._sched_carry = []
        self.actors.cancel_all()

    async def _stats_req(self, _req):
        return self.stats.as_dict()

    async def _committed_version_req(self, _req) -> Version:
        return self.committed_version.get()

    async def _metadata_version_req(self, _req) -> Version:
        """How far this proxy has drained METADATA_TAG — the master's DD
        pops the tag at the minimum over proxies (the reference resolver's
        GC by oldest proxy version, Resolver.actor.cpp:198-224)."""
        return self._metadata_version

    # -- GRV path ------------------------------------------------------------
    async def get_read_version(self, req: GetReadVersionRequest) -> GetReadVersionReply:
        p = Promise()
        self._grv_waiters.append(p)
        if not self._grv_flush_active:
            # explicit flag, not len()==1: the flusher empties the list and
            # then awaits the peer quorum, during which a new arrival would
            # otherwise spawn a second concurrent flusher
            self._grv_flush_active = True
            self._spawn(self._grv_flush(), TaskPriority.PROXY_GRV_TIMER, "grvBatch")
        version = await p.future
        if buggify.buggify():
            # reply delivery lag: the client's GRV is extra stale by the
            # time it reads — MVCC windows and too-old paths get exercised
            await delay(0.05, TaskPriority.PROXY_GRV_TIMER)
        self.stats.add("txn_start_out")
        return GetReadVersionReply(version=max(version, self.committed_version.get()))

    async def _live_committed_version(self) -> Version:
        """Max committed version across EVERY proxy of the generation
        (getLiveCommittedVersion:897): a commit acked by a peer proxy must
        be visible to reads started here afterwards. All peers must reply —
        an unreachable peer may hold the newest acks, so GRVs fail (clients
        retry) until it answers or recovery replaces the generation, exactly
        the reference's confirm-epoch-live stall."""
        own = self.committed_version.get()
        others = [ep for ep in self.cfg.peer_grv_eps
                  if ep.address != self.proc.address]
        if not others:
            return own
        replies = await all_of([
            self.net.request(self.proc.address, ep, None,
                             TaskPriority.PROXY_GRV_TIMER,
                             timeout=SERVER_REQUEST_TIMEOUT)
            for ep in others
        ])
        return max(own, *replies)

    async def _grv_flush(self) -> None:
        """Release queued GRVs within the ratekeeper budget; leftovers wait
        for the next interval's replenishment (back-pressure surfaces as
        start-transaction latency, never an error)."""
        try:
            while True:
                await delay(SERVER_KNOBS.grv_batch_interval, TaskPriority.PROXY_GRV_TIMER)
                self._replenish_grv_budget()
                n = len(self._grv_waiters)
                if self._grv_budget != float("inf"):
                    n = min(n, int(self._grv_budget))
                    self._grv_budget -= n
                release, self._grv_waiters = self._grv_waiters[:n], self._grv_waiters[n:]
                try:
                    version = await self._live_committed_version()
                except error.FDBError as e:
                    # A peer proxy is unreachable: these starts cannot be
                    # causally confirmed. Fail them retryably.
                    for p in release:
                        if not p.is_set:
                            p.send_error(error.connection_failed(
                                f"proxy liveness quorum failed: {e.name}"))
                    if not self._grv_waiters:
                        return
                    continue
                for p in release:
                    p.send(version)
                if not self._grv_waiters:
                    return
        finally:
            self._grv_flush_active = False

    # -- locations -----------------------------------------------------------
    async def get_key_server_locations(self, req: GetKeyServerLocationsRequest) -> GetKeyServerLocationsReply:
        out: List[Tuple[KeyRange, List[str]]] = []
        for s, cb, ce in self.routing.shards.shards_of_range(req.begin, req.end):
            out.append((KeyRange(cb, ce), self.routing.addrs(s)))
        return GetKeyServerLocationsReply(results=out)

    # -- commit path -----------------------------------------------------------
    async def commit(self, req: CommitTransactionRequest) -> CommitReply:
        self.stats.add("txn_commit_in")
        adm = self.cfg.tenant_admission
        tenant = getattr(req, "tenant", None)
        if adm is not None and tenant is not None:
            from ..sim.loop import now as _now

            if not adm.admit(tenant, _now()):
                # shed BEFORE the batcher: a rejected commit costs the
                # tenant a typed error and a client-side backoff, never a
                # slot in the batch queue (docs/real_cluster.md)
                self.stats.add("txn_commit_throttled")
                raise error.transaction_throttled(f"tenant {tenant}")
        p = Promise()
        self._commit_queue.send((req.transaction, p))
        try:
            return await p.future
        except error.FDBError as e:
            if (e.name == "transaction_conflict_predicted"
                    and adm is not None and tenant is not None):
                # a pre-abort consumed no resolver capacity: hand the
                # admission token back so the client's refreshed retry
                # isn't double-charged (server/ratekeeper.py refund)
                adm.refund(tenant)
            raise

    async def idle_committer(self) -> None:
        """Commit an empty batch when idle (the reference's interval-driven
        commitBatcher): keeps the version chain, the tlogs' KCV horizon and
        — critically — every proxy's metadata drain advancing even with no
        client traffic, so routing changes (MoveKeys) become visible
        without waiting for the next client commit."""
        from ..sim.loop import now

        while not self._dead:
            interval = IDLE_COMMIT_INTERVAL
            if buggify.buggify():
                # hyperactive idle committer: floods the version chain with
                # empty batches (tiny version deltas, KCV churn)
                interval = IDLE_COMMIT_INTERVAL / 10
            await delay(interval, TaskPriority.PROXY_COMMIT_BATCHER)
            if now() - self._last_batch_time < IDLE_COMMIT_INTERVAL:
                continue
            W = self.cfg.commit_pipeline_window
            if W and self.batch_logging.get() < self._batch_num + 1 - W:
                # in-flight window full: an empty batch can't advance the
                # KCV horizon (phase-4 pushes are ordered behind the stall)
                # and would breach the bound the window exists to enforce
                continue
            sched = self.conflict_sched
            items: List[Tuple[CommitTransaction, Promise]] = []
            if sched.enabled and (self._sched_carry or sched.pending_laned()):
                # idle drain: laned and carried transactions must keep
                # flowing when no fresh commit wakes the batcher — the
                # idle batch carries them instead of running empty
                cap = min(self.cfg.max_commit_batch or MAX_COMMIT_BATCH,
                          SERVER_KNOBS.commit_transaction_batch_count_max)
                plan = sched.select(self._sched_carry, cap)
                self._sched_carry = plan.remaining
                for (_t, pr), rng in plan.preaborts:
                    if not pr.is_set:
                        self.stats.add("txn_commit_preaborted")
                        pr.send_error(error.transaction_conflict_predicted(
                            f"range {rng.hex()}"))
                items = plan.dispatch
            self._batch_num += 1
            self._last_batch_time = now()
            self._spawn(
                self.commit_batch(self._batch_num, items),
                TaskPriority.PROXY_COMMIT_DISPATCH,
                f"idleBatch:{self._batch_num}",
            )

    async def commit_batcher(self) -> None:
        """Dynamic-interval batcher (reference: batcher.actor.h via
        MasterProxyServer.actor.cpp:880-886)."""
        pending = self._commit_queue.stream.pop()
        while True:
            first = await pending
            pending = self._commit_queue.stream.pop()
            batch = [first]
            deadline = delay(SERVER_KNOBS.commit_transaction_batch_interval,
                             TaskPriority.PROXY_COMMIT_BATCHER)
            cap = min(self.cfg.max_commit_batch or MAX_COMMIT_BATCH,
                      SERVER_KNOBS.commit_transaction_batch_count_max)
            if self._commit_batch_target is not None:
                # budget-driven sizing (pipeline/resolver_pipeline.py
                # BudgetBatcher via ratekeeper): batches beyond the largest
                # in-budget resolver bucket would blow the p99 commit budget
                cap = max(1, min(cap, self._commit_batch_target))
            if buggify.buggify():
                cap = 1  # force single-transaction batches: deep pipelines
            while len(batch) < cap:
                which, _ = await any_of([pending, deadline])
                if which == 1:
                    break
                batch.append(pending.get())
                pending = self._commit_queue.stream.pop()
            W = self.cfg.commit_pipeline_window
            # In-flight window gate: dispatch only when fewer than W batches
            # sit between dispatch and fully-logged; keep filling the batch
            # (up to cap) while waiting so backpressure becomes batch size,
            # not queue depth. Re-checked against a fresh _batch_num each
            # pass — the idle committer may claim numbers while we wait.
            while W and self.batch_logging.get() < self._batch_num + 1 - W:
                gate = self.batch_logging.when_at_least(self._batch_num + 1 - W)
                while not gate.is_ready and len(batch) < cap:
                    which, _ = await any_of([pending, gate])
                    if which == 0:
                        batch.append(pending.get())
                        pending = self._commit_queue.stream.pop()
                if not gate.is_ready:
                    await gate
            sched = self.conflict_sched
            if sched.enabled:
                # conflict-aware admission (pipeline/scheduler.py): the
                # carry (previous ticks' deferrals) goes ahead of this
                # batch's arrivals; pre-aborted commits are rejected here
                # with the retryable typed error, laned/deferred entries
                # wait in the scheduler or the carry for a later batch
                plan = sched.select(self._sched_carry + batch, cap)
                self._sched_carry = plan.remaining
                for (_t, pr), rng in plan.preaborts:
                    if not pr.is_set:
                        self.stats.add("txn_commit_preaborted")
                        pr.send_error(error.transaction_conflict_predicted(
                            f"range {rng.hex()}"))
                batch = plan.dispatch
            self._batch_num += 1
            from ..sim.loop import now as _now

            self._last_batch_time = _now()
            self._spawn(
                self.commit_batch(self._batch_num, batch),
                TaskPriority.PROXY_COMMIT_DISPATCH,
                f"commitBatch:{self._batch_num}",
            )

    async def commit_batch(self, bn: int, items: List[Tuple[CommitTransaction, Promise]]) -> None:
        try:
            await self._commit_batch_impl(bn, items)
        except error.FDBError as e:
            # A role failed mid-batch: clients must assume the worst
            # (commit_unknown_result); epoch-end recovery decides which
            # in-flight versions survived.
            self.batch_resolving.advance(bn)
            self.batch_logging.advance(bn)
            versions = self._batch_versions.pop(bn, None)
            attempted = self._batch_messages.pop(bn, None)
            pending_rn = self._pending_master_req.pop(bn, None)
            if e.code == _TLOG_STOPPED:
                # Our generation has been locked by a successor: this proxy
                # is permanently done. No repair — the successor owns the
                # chain now.
                for _, pr in items:
                    if not pr.is_set:
                        pr.send_error(error.commit_unknown_result(e.name))
                self.shutdown()
                return
            if versions is not None:
                # Version v is in the master's chain but may never have
                # reached the resolvers/tlog; plug the hole or every later
                # batch waits on when_at_least(v) forever. Resolvers and the
                # tlog dedupe versions, so repair is idempotent. A batch
                # that already ATTEMPTED its push repairs with the original
                # payload (see _batch_messages).
                self._spawn(self._repair_chain(*versions, messages=attempted or {}),
                            TaskPriority.PROXY_COMMIT, f"repair:{bn}")
            elif pending_rn is not None:
                # The GetCommitVersion reply was lost (request_maybe_delivered)
                # — the master may still have advanced its chain for us. Ask
                # again with the same request_num: the dedup window replays the
                # same (prev, version) pair if the original landed, or mints a
                # fresh pair (which we immediately plug) if it never did.
                self._spawn(
                    self._repair_unknown_version(pending_rn),
                    TaskPriority.PROXY_COMMIT,
                    f"repairUnknown:{bn}",
                )
            for _, p in items:
                if not p.is_set:
                    p.send_error(error.commit_unknown_result(e.name))

    async def _drain_metadata(self, upto: Version) -> None:
        """Apply every METADATA_TAG entry with version <= upto to the
        routing state. The peek horizon is the log's known-committed
        version; while it trails, re-advertise our own committed version to
        the replicas (the KCV one-ways after an ack are unreliable, and the
        next carrier would otherwise be the very push this drain gates)."""
        attempts = 0
        while self._metadata_version < upto and not self._dead:
            if buggify.buggify():
                # stall the drain: later batches pile up behind phase 3.5
                await delay(0.05, TaskPriority.PROXY_COMMIT)
            floor_before = self._metadata_version
            try:
                # Advertise our committed version first: the peek blocks on
                # the tlog's known-committed horizon, and when no later push
                # is in flight to carry the KCV forward (an idle or sparse
                # commit pipeline), the replica would otherwise sit at the
                # full peek timeout before the retry path advertises it.
                self.log.send_kcv(self.committed_version.get())
                reply = await self.log.peek(
                    METADATA_TAG, self._metadata_version + 1, timeout=1.0)
            except error.FDBError as e:
                attempts += 1
                if attempts >= int(SERVER_REQUEST_TIMEOUT * 4):
                    raise
                self.log.send_kcv(self.committed_version.get())
                await delay(0.25, TaskPriority.PROXY_COMMIT)
                continue
            for mv, muts in reply.messages:
                if mv <= self._metadata_version or mv > upto:
                    continue
                for m in muts:
                    self.routing.apply_mutation(m)
            new_floor = min(reply.end_version, upto)
            if new_floor <= floor_before:
                if self._metadata_version > floor_before:
                    # A concurrent drain (phase 3.5 of an overlapping batch)
                    # advanced the floor while our peek was in flight: that
                    # is progress, not a stall — re-check immediately. The
                    # backoff below would otherwise park this batch (and,
                    # through the ordered phase-4 push, every batch behind
                    # it) for the full retry interval.
                    continue
                attempts += 1
                if attempts >= int(SERVER_REQUEST_TIMEOUT * 4):
                    raise error.timed_out("metadata drain stalled")
                self.log.send_kcv(self.committed_version.get())
                await delay(0.25, TaskPriority.PROXY_COMMIT)
                continue
            attempts = 0
            self._metadata_version = max(self._metadata_version, new_floor)

    async def _repair_unknown_version(self, request_num: int) -> None:
        """Recover the version pair for a lost GetCommitVersion exchange and
        plug the resulting chain hole (ADVICE r1: a lost master reply after
        the master advanced left an orphaned version that stalled every later
        batch's when_at_least)."""
        while not self._dead:
            try:
                vr = await self.net.request(
                    self.proc.address,
                    self.cfg.master_ep,
                    GetCommitVersionRequest(request_num, self.proc.address),
                    TaskPriority.PROXY_COMMIT,
                    timeout=SERVER_REQUEST_TIMEOUT,
                )
                break
            except error.FDBError as e:
                if e.code == _TLOG_STOPPED:
                    self.shutdown()
                    return
                await delay(0.1)
        if self._dead:
            return
        await self._repair_chain(vr.prev_version, vr.version)

    async def _repair_chain(self, prev_v: Version, v: Version,
                            messages: Optional[Dict[int, List[Mutation]]] = None) -> None:
        """Push a batch for (prev_v, v) until every chained consumer has it
        — with the ORIGINAL payload when the failed batch had already
        attempted its push (a partial push may have landed on some tlog
        replicas; re-pushing identical bytes converges them, an empty push
        would diverge them). Epoch-ending recovery supersedes it when this
        generation is deposed (shutdown cancels the loop)."""
        while not self._dead:
            try:
                for ep in self.cfg.resolver_eps:
                    await self.net.request(
                        self.proc.address,
                        ep,
                        ResolveTransactionBatchRequest(
                            prev_version=prev_v, version=v,
                            last_received_version=prev_v, transactions=[],
                        ),
                        TaskPriority.PROXY_RESOLVER_REPLY,
                        timeout=SERVER_REQUEST_TIMEOUT,
                    )
                await self.log.push(prev_v, v, messages or {},
                                    self.committed_version.get())
                if v > self.committed_version.get():
                    self.committed_version.set(v)
                return
            except error.FDBError as e:
                if e.code == _TLOG_STOPPED:
                    self.shutdown()
                    return
                await delay(0.1)

    async def _commit_batch_impl(self, bn: int, items: List[Tuple[CommitTransaction, Promise]]) -> None:
        cfg = self.cfg
        n_res = len(cfg.resolver_eps)
        # span anchors (docs/observability.md): the batch's trace id is its
        # commit version, known only after phase 1 — timestamps are taken
        # along the way and the spans emitted retroactively
        spans_on = g_spans.enabled
        t_start = span_now() if spans_on else 0.0

        # ---- Phase 1: take a commit version, in batch order (:361) ----
        await self.batch_resolving.when_at_least(bn - 1)
        self._request_num += 1
        self._pending_master_req[bn] = self._request_num
        vr = await self.net.request(
            self.proc.address,
            cfg.master_ep,
            GetCommitVersionRequest(self._request_num, self.proc.address),
            TaskPriority.PROXY_COMMIT,
            timeout=SERVER_REQUEST_TIMEOUT,
        )
        self._pending_master_req.pop(bn, None)
        prev_v, v = vr.prev_version, vr.version
        self._batch_versions[bn] = (prev_v, v)
        if spans_on:
            t_version = span_now()
            span_event("proxy.get_version", v, t_start, t_version,
                       parent="proxy.commit_batch")
        rv = getattr(vr, "routing_version", 0)
        if rv and (not self._routing_flips or rv > self._routing_flips[-1][0]):
            self._routing_flips.append((rv, tuple(vr.routing_old_splits),
                                        tuple(vr.routing_splits)))
        # The resolver map THIS batch splits by: the newest flip at or
        # below its commit version (phase 1 orders flips exactly —
        # versions >= a flip are only ever handed out carrying it)
        flip_v, _flip_old, flip_new = 0, (), ()
        for fv, fo, fn in reversed(self._routing_flips):
            if v >= fv:
                flip_v, _flip_old, flip_new = fv, fo, fn
                break
        if flip_v:
            res_shards = KeyShardMap(list(flip_new))
        else:
            res_shards = cfg.resolver_shards

        # Build per-resolver transaction views (clipped conflict ranges).
        per_res: List[List[CommitTransaction]] = [[] for _ in range(n_res)]
        # txn -> [(resolver, index within that resolver's batch)]
        per_res_idx: List[List[Tuple[int, int]]] = []
        for t, (txn, _) in enumerate(items):
            views: Dict[int, CommitTransaction] = {}

            def view(r: int) -> CommitTransaction:
                if r not in views:
                    views[r] = CommitTransaction(read_snapshot=txn.read_snapshot)
                return views[r]

            for rng in txn.read_conflict_ranges:
                if rng.begin >= rng.end:
                    r = res_shards.shard_of_point_below(rng.begin)
                    view(r).read_conflict_ranges.append(rng)
                else:
                    for r, cb, ce in res_shards.shards_of_range(rng.begin, rng.end):
                        view(r).read_conflict_ranges.append(KeyRange(cb, ce))
            for rng in txn.write_conflict_ranges:
                if rng.begin < rng.end:
                    for r, cb, ce in res_shards.shards_of_range(rng.begin, rng.end):
                        view(r).write_conflict_ranges.append(KeyRange(cb, ce))
            placed = []
            for r, vw in views.items():
                placed.append((r, len(per_res[r])))
                per_res[r].append(vw)
            per_res_idx.append(placed)

        if buggify.buggify():
            # Stretch phase 1->2 so more batches pile into the pipeline.
            await delay(0.01, TaskPriority.PROXY_COMMIT)

        # ---- Phase 2: resolve everywhere; next batch may start (:417) ----
        attach_flip = flip_v if (flip_v and v >= flip_v) else 0
        resolve_futures = [
            self.net.request(
                self.proc.address,
                ep,
                ResolveTransactionBatchRequest(
                    prev_version=prev_v,
                    version=v,
                    last_received_version=prev_v,
                    transactions=per_res[r],
                    routing_version=attach_flip,
                    routing_old_splits=_flip_old if attach_flip else (),
                    routing_splits=flip_new if attach_flip else (),
                ),
                TaskPriority.PROXY_RESOLVER_REPLY,
                timeout=SERVER_REQUEST_TIMEOUT,
            )
            for r, ep in enumerate(cfg.resolver_eps)
        ]
        self.batch_resolving.advance(bn)
        replies: List[ResolveTransactionBatchReply] = await all_of(resolve_futures)
        if spans_on:
            t_resolved = span_now()
            span_event("proxy.resolve_rpc", v, t_version, t_resolved,
                       parent="proxy.commit_batch")

        # ---- Phase 3: combine votes with min (:489-500) ----
        verdicts: List[int] = []
        for t in range(len(items)):
            placed = per_res_idx[t]
            if not placed:
                verdicts.append(int(TransactionCommitResult.COMMITTED))
            else:
                verdicts.append(min(int(replies[r].committed[i]) for r, i in placed))

        # ---- Phase 3.5: drain the metadata stream to prev_v ----
        # Routing below must reflect every keyServers change with version
        # <= prev_v (commit versions form one global chain, so prev_v is
        # exactly "everything before this batch"). The committing proxy of
        # a metadata txn copies its system mutations into METADATA_TAG
        # (phase 4 below), which this drain consumes — the txnState-tag /
        # ApplyMetadataMutation circuit of the reference.
        await self._drain_metadata(prev_v)
        if spans_on:
            t_drained = span_now()
            span_event("proxy.meta_drain", v, t_resolved, t_drained,
                       parent="proxy.commit_batch")

        # Database lock (lockDatabase / DR switchover): authoritative
        # through prev_v after the drain. User transactions are rejected;
        # lock-aware (management) transactions pass. A commit sharing the
        # LOCK transaction's own batch still lands at the fence version and
        # is drained by DR — nothing a client saw acked is lost.
        if self.routing.db_locked:
            for t, (txn, _p) in enumerate(items):
                if (verdicts[t] == int(TransactionCommitResult.COMMITTED)
                        and not getattr(txn, "lock_aware", False)):
                    verdicts[t] = _VERDICT_LOCKED

        if self.conflict_sched.enabled and items:
            # predictor feedback (pipeline/scheduler.py): committed writes
            # stamp last-write versions, conflicts re-score their ranges
            self.conflict_sched.observe_batch(
                [txn for txn, _p in items], verdicts, v)

        # Assign committed mutations to storage tags, preserving batch order.
        # Versionstamped mutations become SET_VALUE here, stamped with
        # (commit version, index in batch) — the reference does this while
        # building resolver requests (MasterProxyServer.actor.cpp:270-275);
        # doing it post-verdict is equivalent because only the mutation
        # payload changes, never the conflict ranges.
        messages: Dict[int, List[Mutation]] = {}
        meta_muts: List[Mutation] = []
        backup_muts: List[Mutation] = []
        for t, (txn, _) in enumerate(items):
            if verdicts[t] != int(TransactionCommitResult.COMMITTED):
                continue
            for m in txn.mutations:
                if m.type in VERSIONSTAMP_MUTATIONS:
                    m = transform_versionstamp_mutation(m, v, t)
                if m.type != MutationType.CLEAR_RANGE and is_system_key(m.param1):
                    meta_muts.append(m)
                elif self.routing.backup_tag is not None:
                    # live backup: copy every committed USER mutation into
                    # the backup's log tag (the reference's backup ranges
                    # via ApplyMetadataMutation)
                    backup_muts.append(m)
                # Every team member's tag receives the mutation (the
                # reference tags each mutation for all replicas of its
                # shard, MasterProxyServer.actor.cpp:516-756).
                if m.type == MutationType.CLEAR_RANGE:
                    for s, cb, ce in self.routing.shards.shards_of_range(m.param1, m.param2):
                        clipped = Mutation(m.type, cb, ce)
                        for tag in self.routing.write_tags(s):
                            messages.setdefault(tag, []).append(clipped)
                else:
                    s = self.routing.shards.shard_of_key(m.param1)
                    for tag in self.routing.write_tags(s):
                        messages.setdefault(tag, []).append(m)
        if meta_muts:
            messages[METADATA_TAG] = meta_muts
        if backup_muts and self.routing.backup_tag is not None:
            messages[self.routing.backup_tag] = backup_muts

        # ---- Phase 4: log, in version order (:805) ----
        await self.batch_logging.when_at_least(bn - 1)
        self._batch_messages[bn] = messages
        await self.log.push(prev_v, v, messages, self.committed_version.get())
        self._batch_messages.pop(bn, None)
        self.batch_logging.advance(bn)
        if spans_on:
            t_logged = span_now()
            span_event("proxy.log_push", v, t_drained, t_logged,
                       parent="proxy.commit_batch")
            span_event("proxy.commit_batch", v, t_start, t_logged,
                       txns=len(items))
        # Apply our own committed metadata now (idempotent under the later
        # drain): this proxy's location replies must reflect a move it
        # itself just committed.
        for m in meta_muts:
            self.routing.apply_mutation(m)

        # ---- Phase 5: report (:824-860) ----
        self._batch_versions.pop(bn, None)
        if v > self.committed_version.get():
            self.committed_version.set(v)
            # Advertise the new KCV to the replicas now (unreliable one-way;
            # the drain's retry path re-sends on loss). Without this the
            # next batch's metadata drain waits on its OWN push for the
            # horizon — storage pops used to paper over it by carrying
            # fresh durable versions, which the durable tier no longer does.
            self.log.send_kcv(v)
        for t, (_, p) in enumerate(items):
            verdict = verdicts[t]
            if verdict == int(TransactionCommitResult.COMMITTED):
                self.stats.add("txn_committed")
                p.send(CommitReply(version=v, txn_batch_index=t))
            elif verdict == int(TransactionCommitResult.TOO_OLD):
                self.stats.add("txn_too_old")
                p.send_error(error.transaction_too_old())
            elif verdict == _VERDICT_LOCKED:
                self.stats.add("txn_rejected_locked")
                p.send_error(error.database_locked())
            else:
                self.stats.add("txn_conflicted")
                p.send_error(error.not_committed())
