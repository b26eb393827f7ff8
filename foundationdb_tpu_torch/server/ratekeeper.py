"""Ratekeeper: cluster-wide admission control.

Port of ``foundationdb_tpu/server/ratekeeper.py``.

Re-design of fdbserver/Ratekeeper.actor.cpp (updateRate:251-430): poll
every storage server's queue state, translate the worst lag into a
transactions-per-second limit, and meter GRV release at the proxies
(getRate loop, MasterProxyServer.actor.cpp:86). The sim analog of the
reference's storage-queue-bytes signal is the MVCC version lag (how far a
storage server trails the committed version) plus its un-snapshotted WAL
depth — both directly bound crash-recovery work and window health.

Runs as an actor inside the master's epoch (the reference's 6.0 ratekeeper
lives under the master's data distribution); proxies fetch the limit on a
short interval and release that many GRVs per second, queueing the rest —
back-pressure reaches clients as start-transaction latency, exactly like
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core import error
from ..core.knobs import SERVER_KNOBS
from ..sim.loop import TaskPriority, delay
from ..sim.network import Endpoint

STORAGE_QUEUE_INFO_TOKEN = "storage.queueInfo"
GET_RATE_INFO_TOKEN = "master.getRateInfo"

#: version lag at which throttling reaches zero admission (the MVCC window
#: itself is 5e6; throttle to a halt well before readable versions fall out)
MAX_STORAGE_LAG_VERSIONS = 4_000_000
#: lag at which throttling begins
TARGET_STORAGE_LAG_VERSIONS = 1_000_000


@dataclass
class StorageQueueInfo:
    tag: int
    version: int
    durable_version: int
    #: overlay bytes not yet in the durable engine (the reference's
    #: storage-queue-bytes signal; durable VERSION lag is by design
    #: ~storage_durability_lag_versions and is NOT a throttling signal)
    queue_bytes: int = 0


@dataclass
class TLogQueueInfo:
    """One tlog replica's queue state (the reference's TLogQueueInfo):
    in-memory index bytes + the spill-tier debt a slow consumer built."""

    mem_bytes: int = 0
    spilled_version: int = 0
    version: int = 0


@dataclass
class GetRateInfoRequest:
    proxy_id: str


@dataclass
class GetRateInfoReply:
    tps_limit: float
    #: adaptive commit-batch cap from the resolvers' budget batchers
    #: (min across resolvers; None = no resolver reported a target) — the
    #: proxy's commit batcher clamps its batch size to it, closing the
    #: resolver -> ratekeeper -> proxy sizing loop
    commit_batch_target: Optional[int] = None


class TenantAdmission:
    """Per-tenant token-bucket admission control for the commit path.

    The ratekeeper publishes ONE cluster rate; under multi-tenant skewed
    load that lets a single hot tenant consume the whole budget and queue
    everyone else past the p99 SLO (docs/real_cluster.md). This splits the
    published rate into per-tenant buckets by weight: `admit()` spends a
    token or answers False, and the proxy (server/proxy.py) turns False
    into the typed `transaction_throttled` error — a microsecond rejection
    the client retries with backoff, instead of a multi-second queue entry
    that blows the budget for every tenant.

    Fed from the same ratekeeper reply the proxy already fetches
    (GetRateInfoReply.tps_limit, refreshed by `set_rate`); the wall-clock
    chaos server (real/nemesis.py) feeds it a degraded-fraction rate the
    same way the ratekeeper's resolver-health signal scales tps_limit.
    Clock-agnostic: callers pass `now` (sim virtual time or monotonic)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 burst_s: Optional[float] = None):
        #: tenant -> relative weight (unknown tenants weigh 1.0)
        self.weights: Dict[str, float] = dict(weights or {})
        self.burst_s = float(burst_s if burst_s is not None
                             else SERVER_KNOBS.tenant_admission_burst_s)
        #: total admission rate across tenants (inf = admission off)
        self.rate_limit: float = float("inf")
        #: tenant -> [tokens, last_refill_t]
        self._buckets: Dict[str, List[float]] = {}
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}
        self.refunded: Dict[str, int] = {}

    def set_rate(self, tps_limit: float) -> None:
        self.rate_limit = float(tps_limit)

    def tenant_rate(self, tenant: str) -> float:
        """This tenant's share: weight-proportional slice of the published
        rate across every tenant seen so far (plus this one)."""
        if self.rate_limit == float("inf"):
            return float("inf")
        active = set(self._buckets) | {tenant}
        total_w = sum(self.weights.get(t, 1.0) for t in active)
        return self.rate_limit * self.weights.get(tenant, 1.0) / max(total_w, 1e-9)

    def admit(self, tenant: str, now: float) -> bool:
        rate = self.tenant_rate(tenant)
        if rate == float("inf"):
            self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
            return True
        bucket = self._buckets.get(tenant)
        burst = max(1.0, rate * self.burst_s)
        if bucket is None:
            bucket = self._buckets[tenant] = [burst, now]
        tokens, last = bucket
        tokens = min(burst, tokens + rate * max(0.0, now - last))
        if tokens >= 1.0:
            bucket[0], bucket[1] = tokens - 1.0, now
            self.admitted[tenant] = self.admitted.get(tenant, 0) + 1
            return True
        bucket[0], bucket[1] = tokens, now
        self.rejected[tenant] = self.rejected.get(tenant, 0) + 1
        return False

    def refund(self, tenant: str) -> None:
        """Return one admission token. The conflict scheduler's pre-abort
        (pipeline/scheduler.py) refuses an admitted transaction before it
        consumes ANY device capacity — the retry the client sends with a
        fresh read version must not be double-charged against the
        tenant's bucket, or pre-abort would convert conflict aborts into
        throttle rejections instead of commits."""
        rate = self.tenant_rate(tenant)
        if rate == float("inf"):
            return
        bucket = self._buckets.get(tenant)
        if bucket is None:
            return
        burst = max(1.0, rate * self.burst_s)
        bucket[0] = min(burst, bucket[0] + 1.0)
        self.refunded[tenant] = self.refunded.get(tenant, 0) + 1

    def as_dict(self) -> dict:
        return {
            "rate_limit": (None if self.rate_limit == float("inf")
                           else round(self.rate_limit, 1)),
            "burst_s": self.burst_s,
            "admitted": dict(self.admitted),
            "rejected": dict(self.rejected),
            "refunded": dict(self.refunded),
        }


class Ratekeeper:
    """Polls storage; computes the cluster TPS limit (rateKeeper:509)."""

    def __init__(self, net, src_addr: str, storage_tags, committed_version_fn,
                 log_config=None, resolver_eps=None):
        self.net = net
        self.src = src_addr
        self.storage_tags = storage_tags            # (tag, begin, end, addr)
        self.committed_version_fn = committed_version_fn
        #: LogSystemConfig of the serving generation: the tlog queue-depth
        #: signal polls its replicas (None = storage signals only)
        self.log_config = log_config
        #: resolver engine-health endpoints (resolver.health tokens): a
        #: degraded conflict engine — retrying under its watchdog, failed
        #: over to the CPU oracle, or on probation (fault/resilient.py) —
        #: is a throttle signal: its service rate is a fraction of the
        #: device's, and piling on admissions just deepens the queue
        self.resolver_eps = list(resolver_eps or [])
        self.tps_limit: float = float(SERVER_KNOBS.max_transactions_per_second)
        self.worst_lag: int = 0
        #: True while NO storage poll has answered in the last update window:
        #: worst_lag is then a reset placeholder, not a live measurement —
        #: status/telemetry must show signal loss, never a frozen reading
        self.lag_stale: bool = True
        self.worst_tlog_bytes: int = 0
        self.resolver_degraded: bool = False
        #: True while any resolver reports a FIRING burn-rate alert from
        #: its cluster watchdog (core/watchdog.py): the SLO error budget
        #: is being spent faster than sustainable, so admission slows
        #: before the breach lands — the same consume-point the online
        #: resharding controller drives from (server/reshard.py)
        self.burn_alert_firing: bool = False
        #: True while any resolver reports an online reshard in flight
        #: (server/reshard.py ReshardController via engine health): the
        #: handoff is spending host/device time on pre-copy + delta
        #: transfer, and the frozen range briefly queues its batches —
        #: clamp admission by `reshard_tps_fraction` until cutover so the
        #: recovery work stays bounded, exactly like the degraded clamp
        self.reshard_in_flight: bool = False
        #: resolver address -> last reported engine health state
        self.resolver_health: Dict[str, str] = {}
        #: resolver address -> last reported telemetry fragment (engine
        #: perf counters, batcher EWMAs — server/resolver.py engine_health):
        #: rides the same health poll into the master status fragment and
        #: the CC status document (docs/observability.md)
        self.resolver_telemetry: Dict[str, dict] = {}
        #: min adaptive batch target across budget-batching resolvers
        #: (pipeline/service.py target_batch_txns); None = none reported
        self.commit_batch_target: Optional[int] = None

    async def run(self) -> None:
        from ..core import buggify

        interval = SERVER_KNOBS.ratekeeper_update_interval
        while True:
            tick = interval
            if buggify.buggify():
                # stale ratekeeper: proxies run on an old budget while the
                # cluster state moves — metering must degrade gracefully
                tick = interval * 10
            await delay(tick, TaskPriority.RATEKEEPER)
            # concurrent polls: a partition must cost ONE timeout window,
            # not one per unreachable replica (the published rate would
            # otherwise go stale by many update intervals)
            s_futs = [
                self.net.request(
                    self.src, Endpoint(addr, STORAGE_QUEUE_INFO_TOKEN), None,
                    TaskPriority.RATEKEEPER, timeout=interval * 2,
                )
                for _tag, _b, _e, addr in self.storage_tags
            ]
            t_futs = []
            if self.log_config is not None:
                t_futs = [
                    self.net.request(
                        self.src, self.log_config.ep(rep, "queue_info"),
                        None, TaskPriority.RATEKEEPER, timeout=interval * 2,
                    )
                    for rep in self.log_config.tlogs
                ]
            r_futs = [
                (ep, self.net.request(
                    self.src, ep, None, TaskPriority.RATEKEEPER,
                    timeout=interval * 2,
                ))
                for ep in self.resolver_eps
            ]
            infos: List[StorageQueueInfo] = []
            for f in s_futs:
                try:
                    infos.append(await f)
                except error.FDBError:
                    continue  # an unreachable storage doesn't stall the loop
            tlog_infos: List[TLogQueueInfo] = []
            for f in t_futs:
                try:
                    tlog_infos.append(await f)
                except error.FDBError:
                    continue
            resolver_infos: List[dict] = []
            for ep, f in r_futs:
                try:
                    h = await f
                except error.FDBError:
                    # a dead resolver is recovery's problem, not a throttle
                    # signal — but its last health state must not linger in
                    # the status map as if freshly measured, and neither may
                    # its telemetry fragment (stale perf counters rendered
                    # as live would mislead exactly during the incident)
                    self.resolver_health[ep.address] = "unreachable"
                    self.resolver_telemetry.pop(ep.address, None)
                    continue
                self.resolver_health[ep.address] = h.get("state", "healthy")
                if h.get("telemetry"):
                    self.resolver_telemetry[ep.address] = h["telemetry"]
                resolver_infos.append(h)
            targets = [h["target_batch_txns"] for h in resolver_infos
                       if h.get("target_batch_txns") is not None]
            # min wins: a commit batch crosses every resolver, so it must
            # fit the slowest engine's in-budget bucket
            self.commit_batch_target = min(targets) if targets else None
            self.tps_limit = self._update_rate(infos, tlog_infos, resolver_infos)

    def _update_rate(self, infos: List[StorageQueueInfo],
                     tlog_infos: Optional[List[TLogQueueInfo]] = None,
                     resolver_infos: Optional[List[dict]] = None) -> float:
        """The core of updateRate (Ratekeeper.actor.cpp:251-430): four
        signals, the minimum wins —
          * worst storage FETCH lag (committed - applied: how far the
            update loop trails the tlogs);
          * worst storage un-durable queue depth (overlay bytes above the
            engine);
          * worst TLOG queue depth (in-memory index bytes — a tlog buried
            in spill debt is exactly the signal the spill tier used to
            hide from admission control; round-4 weak #8);
          * resolver engine health (fault/resilient.py): a degraded
            conflict engine serves through watchdog retries or the CPU
            failover oracle at a fraction of device throughput — admit
            accordingly until it swaps back.
        Durable-version lag is NOT a signal — the durability cycle trails
        by storage_durability_lag_versions on purpose."""
        max_tps = float(SERVER_KNOBS.max_transactions_per_second)
        tps_lag = tps_bytes = max_tps
        if not infos:
            # Every storage poll timed out: the prior worst_lag no longer
            # corresponds to any live measurement. Reset it and mark it
            # stale rather than publishing a frozen reading.
            self.worst_lag = 0
            self.lag_stale = True
        else:       # no storage reply = no storage signal; the TLOG signal
            #         below must still bite (a buried tlog during a storage
            #         partition is exactly when admission must slow)
            self.lag_stale = False
            committed = self.committed_version_fn()
            self.worst_lag = max(max(0, committed - i.version) for i in infos)
            if self.worst_lag >= MAX_STORAGE_LAG_VERSIONS:
                tps_lag = 1.0  # never fully zero: progress drains the lag
            elif self.worst_lag > TARGET_STORAGE_LAG_VERSIONS:
                frac = (MAX_STORAGE_LAG_VERSIONS - self.worst_lag) / (
                    MAX_STORAGE_LAG_VERSIONS - TARGET_STORAGE_LAG_VERSIONS
                )
                tps_lag = max(1.0, max_tps * frac)
            worst_bytes = max(i.queue_bytes for i in infos)
            target_b = SERVER_KNOBS.target_storage_queue_bytes
            spring_b = SERVER_KNOBS.spring_storage_queue_bytes
            if worst_bytes >= target_b:
                tps_bytes = 1.0
            elif worst_bytes > target_b - spring_b:
                frac = (target_b - worst_bytes) / spring_b
                tps_bytes = max(1.0, max_tps * frac)
        tps_tlog = max_tps
        if tlog_infos:
            self.worst_tlog_bytes = max(t.mem_bytes for t in tlog_infos)
            target_t = SERVER_KNOBS.target_tlog_queue_bytes
            spring_t = max(target_t // 2, 1)
            if self.worst_tlog_bytes >= target_t:
                tps_tlog = 1.0
            elif self.worst_tlog_bytes > target_t - spring_t:
                frac = (target_t - self.worst_tlog_bytes) / spring_t
                tps_tlog = max(1.0, max_tps * frac)
        tps_resolver = max_tps
        tps_watchdog = max_tps
        tps_reshard = max_tps
        if resolver_infos is not None:
            self.resolver_degraded = any(h.get("degraded") for h in resolver_infos)
            if self.resolver_degraded:
                tps_resolver = max(
                    1.0, max_tps * SERVER_KNOBS.resolver_degraded_tps_fraction)
            # watchdog burn-rate clamp (core/watchdog.py): a firing
            # multi-window burn alert means the SLO budget is being spent
            # at an unsustainable rate RIGHT NOW — shed load while the
            # budget still has headroom, exactly like the degraded signal
            # but driven by measured SLO spend instead of engine health
            self.burn_alert_firing = any(h.get("burn_alert_firing")
                                         for h in resolver_infos)
            if self.burn_alert_firing:
                tps_watchdog = max(
                    1.0, max_tps * SERVER_KNOBS.watchdog_burn_tps_fraction)
            # reshard clamp (server/reshard.py): while a range handoff is
            # in flight the published rate scales by reshard_tps_fraction
            # — pre-copy/delta transfer work and the frozen range's brief
            # queueing must not compete with full-rate admission; the
            # clamp lifts on the same poll that reports the cutover
            self.reshard_in_flight = any(h.get("reshard_in_flight")
                                         for h in resolver_infos)
            if self.reshard_in_flight:
                tps_reshard = max(
                    1.0, max_tps * SERVER_KNOBS.reshard_tps_fraction)
        return min(tps_lag, tps_bytes, tps_tlog, tps_resolver, tps_watchdog,
                   tps_reshard)

    async def get_rate_info(self, req: GetRateInfoRequest) -> GetRateInfoReply:
        from ..core import buggify

        limit = self.tps_limit
        if buggify.buggify():
            # brief artificial squeeze: the GRV back-pressure path (queued
            # starts, latency instead of errors) runs even on idle clusters
            limit = max(1.0, limit / 100)
        return GetRateInfoReply(tps_limit=limit,
                                commit_batch_target=self.commit_batch_target)
