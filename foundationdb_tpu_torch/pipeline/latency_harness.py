"""LatencyHarness: client-observed commit latency under open-loop load.

Port of ``foundationdb_tpu/pipeline/latency_harness.py``.

This harness drives an open-loop (Poisson) arrival process through the
full e2e sim cluster — proxy batching, master version chain, pipelined
resolver, tlog push, ordered replies — and reports client-observed
commit-latency percentiles next to sustained throughput.

Time model: the sim runs in virtual time. The resolver's pack and device
service times are INJECTED from measurements on the card (chip_smoke.py
passes the columnar engine's measured one-chunk replay per bucket and its
pack time per transaction). Every other delay — batching, version
chaining, network hops (fixed datacenter-profile latency), tlog commit —
is the sim cluster's own. The engine's own wall time never enters virtual
time. Client-observed commit latency is the virtual time from commit
submission to CommitReply, the reference's commit budget quantity
(performance.rst:36,49).

Verdicts come from the reference-exact oracle engine by default;
`engine_factory` puts a port engine (TorchConflictEngine on the card) in
the resolver instead. The engines are bit-exact with the oracle, so the
same point gives the same result with either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import math


def p99_budget_ms() -> float:
    """The client-observed p99 commit budget (the resolver-inclusive share
    of the reference's < 3 ms end-to-end commit target): the
    `resolver_p99_budget_ms` knob, shared with the BudgetBatcher's
    adaptive batch sizing so the bench filter and the serving-path
    batcher can never disagree."""
    from ..core.knobs import SERVER_KNOBS

    return float(SERVER_KNOBS.resolver_p99_budget_ms)


def in_any_window(t: float, windows) -> bool:
    """True when t falls inside any (t0, t1) interval."""
    return any(w0 <= t <= w1 for w0, w1 in windows)


def percentile_index(n: int, p: float) -> int:
    """THE quantile convention every SLO consumer shares (the nearest-rank
    index the harness has always used); one definition so a future change
    to the rule cannot leave two p99s disagreeing over the same data."""
    return min(n - 1, int(p * n))


def percentile_ms(sorted_ms, p: float) -> float:
    """Percentile of an ascending latency list (ms); nan when empty."""
    if not sorted_ms:
        return float("nan")
    return sorted_ms[percentile_index(len(sorted_ms), p)]


def percentile_outside_windows(records, windows, p: float = 0.99):
    """SLO percentile over ack records whose LIFETIME [t_submit,
    t_submit + latency] intersects no excluded window — the chaos
    campaign's assertion primitive (docs/real_cluster.md): p99 must hold
    outside injected-fault windows; inside them the contract is graceful
    degradation, not the budget. Interval intersection (not submit-time
    membership) is the honest filter: a request submitted just before a
    partition but caught inside it is a window casualty, while one
    submitted earlier that completed before the window counts.

    `records` are (t_submit, latency_s, ok, version) tuples — the same
    shape run_latency_under_load accumulates and real/workload.py records.
    Returns (percentile_ms, n_outside); (nan, 0) when nothing qualifies."""
    lat_ms = sorted(
        l * 1e3 for t0, l, _ok, _v in records
        if not any(t0 <= w1 and t0 + l >= w0 for w0, w1 in windows))
    return percentile_ms(lat_ms, p), len(lat_ms)


@dataclass
class HarnessResult:
    depth: int
    batch_txns: int
    device_ms: float
    pack_ms_per_txn: float
    offered_txns_per_sec: float
    #: RESOLVED rate in the steady window (every acked verdict, committed
    #: or not) — the comparable quantity to the bench latency_curve's
    #: verdict-agnostic txns_per_sec
    sustained_txns_per_sec: float
    #: committed-only rate (the workload's conflict profile discounts it)
    sustained_committed_per_sec: float
    p50_ms: float
    p99_ms: float
    committed: int
    conflicted: int
    errors: int
    mean_batch_fill: float
    #: span-based phase decomposition of client-observed latency
    #: (collect_spans=True; docs/observability.md)
    attribution: Optional[dict] = None

    def as_dict(self) -> dict:
        out = {
            "depth": self.depth,
            "batch_txns": self.batch_txns,
            "device_ms": round(self.device_ms, 4),
            "offered_txns_per_sec": round(self.offered_txns_per_sec, 1),
            "sustained_txns_per_sec": round(self.sustained_txns_per_sec, 1),
            "sustained_committed_per_sec": round(self.sustained_committed_per_sec, 1),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "committed": self.committed,
            "conflicted": self.conflicted,
            "errors": self.errors,
            "mean_batch_fill": round(self.mean_batch_fill, 1),
        }
        if self.attribution is not None:
            out["attribution"] = self.attribution
        return out


#: the named phase segments a client-observed commit latency decomposes
#: into (docs/observability.md). Together they PARTITION the submit->reply
#: interval: batch_wait and the two residuals (resolve_overhead: resolver
#: RPC time outside the resolver's own spans; reply_net: phase-5 reply
#: delivery) absorb network/marshalling, so the segment sum equals the
#: client-observed latency by construction — what the acceptance check
#: verifies end to end through real span timestamps.
ATTRIBUTION_SEGMENTS = (
    "batch_wait",        # client submit -> proxy commit batch dispatched
    "get_version",       # proxy phase 1: master version fetch (+ batch order)
    "queue_wait",        # resolver: version chain + service window slot
    "host_pack",         # resolver service: host pack stage
    "pipeline_wait",     # resolver service: in-order device chain wait
    "device_dispatch",   # step dispatch: device program (retry share removed)
    "queue_enqueue",     # device loop: slot pack + async dispatch (no sync)
    "device_resident",   # device loop: on-device server-step share
    "result_drain",      # device loop: non-blocking abort-bitmap drain
    "retry",             # supervisor watchdog retries (fault/resilient.py)
    "force",             # verdict materialization / readback tail
    "resolve_overhead",  # resolver RPC residual: network + marshalling
    "meta_drain",        # proxy phase 3.5: metadata stream drain
    "log_push",          # proxy phase 4: tlog push (+ logging order wait)
    "reply_net",         # phase 5 reply delivery back to the client
    "device_time",       # OVERLAY: sampled measured enqueue->ready device
                         # interval (ops/host_engine.py, the
                         # resolver_device_time_sample_rate knob) — its
                         # own Chrome device track; overlaps
                         # device_dispatch/device_resident, so the
                         # partition sum excludes it (OVERLAY_SEGMENTS)
)

#: segments that are measured OVERLAYS of the partition, not members of
#: it: they ride the attribution tables and the Chrome export but are
#: excluded from the telescoping sum — including them would double-count
#: the device interval they overlap and break the sum identity.
OVERLAY_SEGMENTS = ("device_time",)


def _attribute(records, by_trace) -> Optional[dict]:
    """Per-txn phase decomposition from the span record (core/trace.py).

    `records` are steady-window (submit_t, latency_s, committed?, version)
    acks; `by_trace` maps a commit version to its summed span durations.
    Only committed acks with a complete span set attribute (a conflict
    verdict has no CommitReply version to join on)."""
    rows = []
    for t0, lat, ok, v in records:
        if not ok or v is None:
            continue
        tr = by_trace.get(v)
        if tr is None:
            continue
        if any(k not in tr for k in ("proxy.commit_batch.t0",
                                     "proxy.get_version", "proxy.resolve_rpc",
                                     "proxy.meta_drain", "proxy.log_push")):
            continue
        qw = tr.get("resolver.queue_wait", 0.0)
        hp = tr.get("resolver.host_pack", 0.0)
        pw = tr.get("resolver.pipeline_wait", 0.0)
        dd = tr.get("resolver.device_dispatch", 0.0)
        # device-loop dispatch (docs/perf.md "Device-resident loop"): the
        # device_dispatch interval splits into enqueue / device-resident /
        # drain segments; a step-dispatch run carries zeros here (and vice
        # versa), so the partition identity holds in either mode
        qe = tr.get("resolver.queue_enqueue", 0.0)
        dr = tr.get("resolver.device_resident", 0.0)
        rd = tr.get("resolver.result_drain", 0.0)
        fc = tr.get("resolver.force", 0.0)
        rt = tr.get("resolver.retry", 0.0)
        seg = {
            "batch_wait": tr["proxy.commit_batch.t0"] - t0,
            "get_version": tr["proxy.get_version"],
            "queue_wait": qw,
            "host_pack": hp,
            "pipeline_wait": pw,
            "device_dispatch": (dd - rt) if dd else 0.0,
            "queue_enqueue": qe,
            "device_resident": (dr - rt) if dr else 0.0,
            "result_drain": rd,
            "retry": rt,
            "force": fc,
            "resolve_overhead": tr["proxy.resolve_rpc"]
                - (qw + hp + pw + dd + qe + dr + rd + fc),
            "meta_drain": tr["proxy.meta_drain"],
            "log_push": tr["proxy.log_push"],
        }
        seg["reply_net"] = lat - sum(seg.values())
        # overlay segments join AFTER the partition closed over reply_net:
        # they are reported, never summed (OVERLAY_SEGMENTS)
        seg["device_time"] = tr.get("engine.device_time", 0.0)
        rows.append((lat, seg))
    if not rows:
        return None
    rows.sort(key=lambda r: r[0])

    def at(p: float) -> dict:
        idx = percentile_index(len(rows), p)
        w = max(1, int(0.02 * len(rows)))
        sel = rows[max(0, idx - w): idx + w + 1]
        segs = {k: sum(s[k] for _, s in sel) / len(sel) * 1e3
                for k in ATTRIBUTION_SEGMENTS}
        client = sum(l for l, _ in sel) / len(sel) * 1e3
        total = sum(v for k, v in segs.items()
                    if k not in OVERLAY_SEGMENTS)
        for k in OVERLAY_SEGMENTS:
            # an overlay nobody measured is not a 0ms measurement — the
            # sim harness injects device time and emits no engine spans,
            # so a structural 0.0 row would read as a (wrong) figure
            if not segs.get(k):
                segs.pop(k, None)
        return {
            "client_ms": round(client, 4),
            "segments_ms": {k: round(v, 4) for k, v in segs.items()},
            "sum_ms": round(total, 4),
            "sum_over_client": round(total / client, 4) if client else None,
        }

    return {
        "n_attributed": len(rows),
        "segments": list(ATTRIBUTION_SEGMENTS),
        "p50": at(0.50),
        "p99": at(0.99),
        "mean": at(0.50) if len(rows) < 3 else {
            "client_ms": round(sum(l for l, _ in rows) / len(rows) * 1e3, 4),
            "segments_ms": {
                k: round(sum(s[k] for _, s in rows) / len(rows) * 1e3, 4)
                for k in ATTRIBUTION_SEGMENTS
                if k not in OVERLAY_SEGMENTS
                or any(s[k] for _, s in rows)},
        },
    }


def run_latency_under_load(
    *,
    depth: int,
    batch_txns: int,
    device_ms: float,
    pack_ms_per_txn: float,
    offered_txns_per_sec: float,
    n_txns: int = 20_000,
    warmup_frac: float = 0.25,
    seed: int = 2026,
    pool: int = 8192,
    reads_per_txn: int = 2,
    writes_per_txn: int = 2,
    net_latency_ms: float = 0.01,
    fsync_ms: float = 0.05,
    snapshot_refresh_ms: float = 0.2,
    sim_timeout_s: float = 120.0,
    proxy_window: Optional[int] = None,
    batch_interval_ms: Optional[float] = None,
    device_ms_by_bucket: Optional[Dict[int, float]] = None,
    budget_ms: Optional[float] = None,
    search_mode_by_bucket: Optional[Dict[int, str]] = None,
    dispatch_mode: str = "step",
    queue_enqueue_ms: float = 0.0,
    result_drain_ms: float = 0.0,
    collect_spans: bool = False,
    engine_factory=None,
    resilient: bool = False,
) -> HarnessResult:
    """One harness point: an e2e sim cluster whose resolver runs the
    pipelined service at `depth` with the given measured service times,
    under open-loop Poisson arrivals at `offered_txns_per_sec`.

    The arrival process is OPEN-LOOP (Harmonia-style offered load): a txn
    is submitted at its arrival time regardless of outstanding ones, so
    queueing shows up as latency, never as reduced offered load. The
    workload is the bench shape — `reads_per_txn` point reads +
    `writes_per_txn` point writes over a `pool`-key hot pool, snapshots
    from a client-side cached read version refreshed every
    `snapshot_refresh_ms` (a GRV cache, so commit latency is measured
    from commit submission like the reference's commit budget).

    `collect_spans=True` turns on commit-path span collection
    (core/trace.py) for the run and attaches a `latency_attribution`
    decomposition to the result: named phase segments that sum to the
    client-observed latency (docs/observability.md). `engine_factory` /
    `resilient` override the resolver's conflict engine (e.g. a
    FaultInjectingEngine under the ResilientEngine supervisor, to measure
    what watchdog retries do to the decomposition)."""
    # Imported here: the harness pulls in the whole sim cluster.
    from ..core import buggify
    from ..core.knobs import SERVER_KNOBS
    from ..core.types import CommitTransaction, KeyRange
    from ..sim.loop import Promise, TaskPriority, delay, now, set_scheduler
    from ..sim.network import Endpoint
    from ..sim.simulator import Simulator
    from ..server.cluster import Cluster, ClusterConfig
    from ..server.messages import CommitTransactionRequest
    from ..server.proxy import COMMIT_TOKEN, COMMITTED_VERSION_TOKEN
    from .service import PipelineConfig

    from ..core.trace import g_spans
    from ..ops.oracle import OracleConflictEngine

    sim = Simulator(seed)
    spans_were_enabled = g_spans.enabled
    # Benchmark profile: no fault injection, fixed datacenter-scale hops
    # (in-rack RTT), NVMe-class tlog fsync, and a device-paced batch
    # deadline. The reference's dynamic batcher tunes its interval to track
    # the commit pipeline's service rate; for a pipelined device resolver the
    # natural operating point is one batch per device program — closing
    # batches faster than the device drains them only deepens the queue,
    # closing slower starves it — so the auto interval is the measured
    # device time plus a small dispatch margin.
    if batch_interval_ms is None:
        batch_interval_ms = max(0.2, 1.04 * device_ms)
    buggify.disable()
    sim.net.min_latency = sim.net.max_latency = net_latency_ms / 1e3
    saved_knobs = {
        "commit_transaction_batch_interval":
            SERVER_KNOBS.commit_transaction_batch_interval,
        "tlog_fsync_seconds": SERVER_KNOBS.tlog_fsync_seconds,
    }
    SERVER_KNOBS._values["commit_transaction_batch_interval"] = batch_interval_ms / 1e3
    SERVER_KNOBS._values["tlog_fsync_seconds"] = fsync_ms / 1e3

    cluster = Cluster(sim, ClusterConfig(
        n_resolvers=1,
        n_proxies=1,
        n_storage=2,
        engine_factory=engine_factory or OracleConflictEngine,
        resilient_resolver=resilient,
        resolver_pipeline=PipelineConfig(
            depth=depth,
            pack_ms_per_txn=pack_ms_per_txn,
            device_ms_per_batch=device_ms,
            max_batch_txns=batch_txns,
            # bucket ladder (docs/perf.md): a batch pays its own bucket's
            # measured device time, and the service's BudgetBatcher reports
            # the adaptive target that — via ratekeeper — caps the proxy's
            # commit batches to the largest in-budget bucket
            device_ms_by_bucket=device_ms_by_bucket,
            p99_budget_ms=budget_ms,
            # per-(bucket, mode) EWMA keying (docs/perf.md history search
            # modes); None = whatever the resolver engine reports
            search_mode_by_bucket=search_mode_by_bucket,
            # device-loop dispatch model (docs/perf.md "Device-resident
            # loop"): splits the device span into enqueue / resident /
            # drain segments with the given injected host shares
            dispatch_mode=dispatch_mode,
            queue_enqueue_ms=queue_enqueue_ms,
            result_drain_ms=result_drain_ms,
        ),
        max_commit_batch=batch_txns,
        # One slot beyond the service depth: `depth` batches in service at
        # the resolver plus one accumulating/in transit at the proxy.
        commit_pipeline_window=proxy_window or depth + 1,
    ))
    net = sim.net
    client = sim.new_process("latency-client")
    proxy_addr = cluster.proxy_proc.address
    commit_ep = Endpoint(proxy_addr, COMMIT_TOKEN)
    cv_ep = Endpoint(proxy_addr, COMMITTED_VERSION_TOKEN)
    rng = sim.sched.rng

    lam = offered_txns_per_sec
    cached_version = [cluster.cfg.start_version]
    #: (submit_time, latency_s, committed?, commit version | None)
    latencies: list = []
    counts = {"committed": 0, "conflicted": 0, "errors": 0, "acked": 0}
    done = Promise()

    async def version_cache() -> None:
        """Client-side GRV cache (the staleness a real client's batched
        GRV would have at this refresh interval)."""
        while not done.is_set:
            try:
                v = await net.request(client.address, cv_ep, None,
                                      TaskPriority.PROXY_GRV_TIMER, timeout=1.0)
                cached_version[0] = max(cached_version[0], v)
            except Exception:
                pass
            await delay(snapshot_refresh_ms / 1e3, TaskPriority.PROXY_GRV_TIMER)

    def make_txn() -> CommitTransaction:
        t = CommitTransaction(read_snapshot=cached_version[0])
        for _ in range(reads_per_txn):
            k = b"lat/%010d" % rng.random_int(0, pool)
            t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        for _ in range(writes_per_txn):
            k = b"lat/%010d" % rng.random_int(0, pool)
            t.set(k, b"v" * 8)
        return t

    async def one_txn() -> None:
        from ..core import error as _error

        t0 = now()
        ok = False
        version = None
        try:
            reply = await net.request(client.address, commit_ep,
                                      CommitTransactionRequest(make_txn()),
                                      TaskPriority.PROXY_COMMIT, timeout=30.0)
            ok = True
            version = getattr(reply, "version", None)
            counts["committed"] += 1
        except _error.FDBError as e:
            # a conflict verdict is a real reply (its latency is honest);
            # anything else is a transport/cluster error
            if e.name in ("not_committed", "transaction_too_old"):
                counts["conflicted"] += 1
            else:
                counts["errors"] += 1
        latencies.append((t0, now() - t0, ok, version))
        counts["acked"] += 1
        if counts["acked"] >= n_txns and not done.is_set:
            done.send(None)

    async def generator() -> None:
        for _ in range(n_txns):
            # exponential interarrival: open-loop Poisson at rate lam
            u = rng.random01()
            await delay(-math.log(max(u, 1e-12)) / lam,
                        TaskPriority.DEFAULT_DELAY)
            sim.sched.spawn(one_txn(), TaskPriority.DEFAULT_DELAY)

    if collect_spans:
        # enabled just before the run (restored in the finally below):
        # the instrumentation only matters while the sim executes
        g_spans.enabled = True
        g_spans.clear()
    try:
        from ..core import error as _error

        sim.sched.spawn(version_cache(), TaskPriority.PROXY_GRV_TIMER)
        sim.sched.spawn(generator(), TaskPriority.DEFAULT_DELAY)
        try:
            sim.run_until(done.future, until=sim_timeout_s)
        except _error.FDBError:
            pass   # saturated point: report whatever acked in the window
    finally:
        for name, val in saved_knobs.items():
            SERVER_KNOBS._values[name] = val
        set_scheduler(None)
        # restore here, not after attribution: an exception mid-run (sim
        # timeout, cluster build failure) must not leak collection enabled
        # into the rest of the process; the recorded spans survive for the
        # attribution pass below
        if collect_spans:
            g_spans.enabled = spans_were_enabled

    # Steady-state window: drop the warmup head (pipeline fill, empty
    # tables, cold batcher) before computing percentiles and throughput.
    latencies.sort(key=lambda r: r[0])
    skip = int(len(latencies) * warmup_frac)
    window = latencies[skip:]
    if not window:
        window = latencies
    attribution = None
    if collect_spans:
        attribution = _attribute(window, g_spans.durations_by_trace())
    # Percentiles over EVERY acked reply, committed or conflicted — the
    # same population the sustained rate counts (a conflict verdict rides
    # the full commit path and is an honest client-observed latency).
    lat_ms = sorted(l * 1e3 for _, l, _ok, _v in window)
    span = window[-1][0] - window[0][0] if len(window) > 1 else 1.0
    sustained = len(window) / max(span, 1e-9)
    sustained_committed = sum(1 for _, _, ok, _v in window if ok) / max(span, 1e-9)

    def pct(p: float) -> float:
        return percentile_ms(lat_ms, p)

    stats = cluster.resolvers[0].stats.as_dict()
    n_batches = max(1, stats.get("batches_resolved", 1))
    return HarnessResult(
        depth=depth,
        batch_txns=batch_txns,
        device_ms=device_ms,
        pack_ms_per_txn=pack_ms_per_txn,
        offered_txns_per_sec=lam,
        sustained_txns_per_sec=sustained,
        sustained_committed_per_sec=sustained_committed,
        p50_ms=pct(0.50),
        p99_ms=pct(0.99),
        committed=counts["committed"],
        conflicted=counts["conflicted"],
        errors=counts["errors"],
        mean_batch_fill=stats.get("txns_in", 0) / n_batches,
        attribution=attribution,
    )
