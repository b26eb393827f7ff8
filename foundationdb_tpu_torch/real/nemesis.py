"""Wall-clock nemesis: SLO-asserted chaos campaigns against the real stack.

Port of ``foundationdb_tpu/real/nemesis.py``.

The sim cluster's DeviceNemesis proves abort-set parity under device
faults in VIRTUAL time; nothing stressed the layers that only exist on
the wall clock — real sockets, reconnect backoff, process supervision,
actual queueing under offered load (ROADMAP item 4). This driver runs a
seeded campaign against the real transport and asserts every SLO by
machine, never by eyeball (docs/real_cluster.md):

  * a wall-clock resolver server (`ChaosCommitServer`): a RealProcess
    serving a commit endpoint over TCP, backed by the SAME supervised
    engine stack production nodes run — ResilientEngine over a
    FaultInjectingEngine over {oracle | torch | device_loop} — with
    per-tenant admission control (server/ratekeeper.TenantAdmission) fed
    a ratekeeper-style degraded-scaled rate;
  * an open-loop Zipfian workload fleet (real/workload.py) driving it
    through `ChaosTransport` shims (real/chaos.py), every client a named
    process the nemesis can partition asymmetrically;
  * a seeded chaos script composing network faults (partitions, drops,
    resets, handshake stalls), device faults (an injected dispatch-fault
    window that must produce a failover AND a swap-back), and process
    kill/restart (a `monitor.Child` demo node killed mid-campaign and
    supervised back up with crash-loop-counted backoff).

After the run, `assert_slos` enforces: client-observed p99 <= the
`resolver_p99_budget_ms` knob OUTSIDE injected-fault windows (via the
span-joined attribution, pipeline/latency_harness helpers); the abort-set
journal replays bit-identical through a clean CPU oracle; loop-mode
`blocking_syncs == 0`; >= 1 failover and >= 1 swap-back; >= 1 supervised
child restart. `main` runs this across seeds under both `torch` (the
card's step engine) and `device_loop` engine modes; `run_served_under_chaos` produces the
bench's Zipf-sweep capacity model (users-served per chip at budget p99,
admission on vs off, nemesis on vs off).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core import blackbox, error, progcache, telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.trace import (
    SPANS_TOKEN,
    TraceContext,
    current_trace_context,
    export_spans,
    g_spans,
    next_trace_id,
    pop_trace_context,
    push_trace_context,
    span_event,
    span_now,
)
from ..tools import trace_export
from ..core.types import CommitTransaction, KeyRange, TransactionCommitResult
from ..sim.network import Endpoint
from .chaos import ChaosConfig, ChaosTransport, NetworkNemesis
from .transport import RealNetwork, RealProcess
from .workload import TenantSpec, WorkloadFleet

COMMIT_TOKEN = "chaos.commit"
STATUS_TOKEN = "chaos.status"

#: version delta per resolved batch and the GC horizon in batches — small
#: enough that shadow rebuilds stay cheap, wide enough that a client whose
#: version cache survives a partition window never goes permanently
#: too-old (clients also refresh their cache off the status endpoint when
#: a too-old verdict tells them they fell behind)
VERSIONS_PER_BATCH = 100
GC_LAG_BATCHES = 400

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _key_range(k) -> KeyRange:
    """Conflict range of one submitted key entry: a point key (bytes)
    covers [k, k\\x00); a (begin, end) pair — the ttl_cache shape's TTL
    sweep — covers the whole [begin, end) segment in ONE range."""
    if isinstance(k, (tuple, list)):
        begin, end = k
        return KeyRange(begin, end)
    return KeyRange(k, k + b"\x00")


def _small_kernel_cfg():
    from ..ops.conflict_kernel import KernelConfig

    # miniature ladder shape: compiles in seconds on CPU, still exercises
    # pack/dispatch/GC exactly like the production shapes
    return KernelConfig(key_words=4, capacity=1024, max_reads=256,
                        max_writes=256, max_txns=64)


def make_chaos_engine(engine_mode: str,
                      dispatch_timeout_s: Optional[float] = None,
                      history_structure: Optional[str] = None,
                      device=None):
    """(inner, injector, supervised) for a campaign engine stack.
    `dispatch_timeout_s` overrides the supervisor's per-dispatch
    watchdog: a co-resident CI box stalls the event loop tens to
    hundreds of ms, and a no-fault control campaign (the watchdog
    false-positive guard) must not read such a stall as a device
    fault — operators tune resolver_dispatch_timeout per deployment
    the same way. `history_structure` selects the device history
    layout ("tiered" = the sorted-run interval table, docs/perf.md
    "Incremental history maintenance") — the oracle mode has no device
    table and ignores it. The card modes ("torch", "device_loop", "mesh")
    build their engine on `device` (None: the card, raising where there is
    none); "mesh" spans `resolver_mesh_devices` shards (0: one per visible
    device of the kind), every shard on that device (None: the cards, as
    parallel/sharding.resolve_devices places them), so a campaign over
    mesh slots exercises the sharded engine's restart and handoff."""
    from ..fault.inject import FaultInjectingEngine, FaultRates
    from ..fault.resilient import ResilienceConfig, ResilientEngine

    if engine_mode == "oracle":
        from ..ops.oracle import OracleConflictEngine

        inner = OracleConflictEngine()
    elif engine_mode in ("torch", "device_loop", "mesh"):
        from ..ops.host_engine import make_engine

        kw = ({"history_structure": history_structure}
              if history_structure else {})
        inner = make_engine(engine_mode, _small_kernel_cfg(), device=device, **kw)
    else:
        raise ValueError(f"unknown chaos engine mode {engine_mode!r}")
    injector = FaultInjectingEngine(
        inner, rates=FaultRates(exception=0, hang=0, slow=0, flip=0, outage=0))
    supervised = ResilientEngine(
        injector,
        ResilienceConfig(
            dispatch_timeout=(0.25 if dispatch_timeout_s is None
                              else float(dispatch_timeout_s)),
            retry_budget=1,
            retry_backoff=0.02, probe_rate=0.05,
            probation_batches=2, failover_min_batches=2),
        record_journal=True)
    return inner, injector, supervised


class _GroupInjector:
    """The device-fault control surface of an elastic group: setting
    `rates` fans the FaultRates to EVERY slot's injector (current slots
    at set time — a fault window opens and closes around the same
    population), so a campaign's forced device-fault window targets the
    shards actually serving, not just whichever engine happened to be
    slot 0 before reshards moved the traffic."""

    def __init__(self, group):
        self._group = group
        self._rates = None

    @property
    def rates(self):
        return self._rates

    @rates.setter
    def rates(self, value) -> None:
        self._rates = value
        for slot in self._group.slots.values():
            slot.injector.rates = value


class ChaosCommitServer:
    """The wall-clock resolver node the campaign aims traffic at: commit
    RPCs batch on the cooperative scheduler and resolve in strict version
    order through the supervised engine; admission sheds over-rate tenants
    with the typed transaction_throttled error before they queue."""

    def __init__(self, sched, engine_mode: str = "oracle",
                 admission_tps: Optional[float] = None,
                 admission_burst_s: Optional[float] = None,
                 batch_interval_s: float = 0.004, max_batch: int = 48,
                 service_floor_s: float = 0.0,
                 transport_degraded_fn=None, port: int = 0,
                 dispatch_timeout_s: Optional[float] = None,
                 elastic: bool = False, reshard: bool = False,
                 reshard_spares: int = 2, conflict_sched=None,
                 history_structure: Optional[str] = None, device=None):
        from ..server.ratekeeper import TenantAdmission
        from .runtime import make_dispatcher

        self.sched = sched
        self.engine_mode = engine_mode
        self._elastic = elastic
        self._reshard_spares = reshard_spares
        self.reshard_ctl = None
        if elastic:
            # the elastic resolution tier (server/reshard.py): a live
            # group of supervised engines behind an epoched shard map,
            # each built through the SAME make_chaos_engine stack —
            # optionally with the heat-driven resharding controller on
            from ..pipeline.resolver_pipeline import BudgetBatcher
            from ..server.reshard import (ElasticResolverGroup,
                                          ReshardController)

            ladder = sorted({max(8, max_batch // 8), max_batch})
            group = ElasticResolverGroup(
                lambda: make_chaos_engine(
                    engine_mode, dispatch_timeout_s=dispatch_timeout_s,
                    history_structure=history_structure, device=device),
                make_batcher=lambda: BudgetBatcher(ladder))
            self.inner, self.engine = group, group
            self.injector = _GroupInjector(group)
            if reshard:
                self.reshard_ctl = ReshardController(
                    group, on_complete=self._on_reshard_complete)
        else:
            self.inner, self.injector, self.engine = make_chaos_engine(
                engine_mode, dispatch_timeout_s=dispatch_timeout_s,
                history_structure=history_structure, device=device)
        self.proc = RealProcess(port=port)
        self.proc.dispatcher = make_dispatcher(sched)
        self.proc.register(COMMIT_TOKEN, self._commit)
        self.proc.register(STATUS_TOKEN, self._status)
        # bounded span-ring export (docs/observability.md "Distributed
        # tracing"): tools/cli.py `trace fetch` and the smoke driver pull
        # this process's spans to reconstruct cross-process waterfalls
        self.proc.register(SPANS_TOKEN, self._spans)
        #: span-record recorder label: the process's self-declared name
        #: when it has one (a --serve child), else the in-campaign
        #: logical name — two traced server processes must not collapse
        #: into one indistinguishable pid lane in the Chrome export
        from ..core.trace import process_name

        self._span_proc = process_name() or "server"
        #: the engine's keyspace-heat aggregator (None for the oracle):
        #: the black-box journal's heat briefs and per-batch witness
        #: attribution read through it (core/blackbox.py)
        if elastic:
            self._heat_agg = self.engine.heat
        else:
            self._heat_agg = getattr(self.inner, "heat", None)
        #: conflict-aware admission scheduling (pipeline/scheduler.py):
        #: None = the resolver_sched knob decides; a SchedConfig is used
        #: as-is; any other truthy/falsy value forces enabled on/off over
        #: the knob family's tuning. Disabled, the scheduler is inert —
        #: select() is the same FIFO slice the batcher always took.
        from ..pipeline.scheduler import ConflictScheduler, SchedConfig

        if isinstance(conflict_sched, SchedConfig):
            sched_cfg = conflict_sched
        else:
            sched_cfg = SchedConfig.from_knobs()
            if conflict_sched is not None:
                sched_cfg.enabled = bool(conflict_sched)
        self.conflict_sched = ConflictScheduler(
            sched_cfg, heat=self._heat_agg, entry_txn=lambda e: e[0])
        self.batch_interval_s = batch_interval_s
        self.max_batch = max_batch
        #: injected per-batch service floor: the campaign's stand-in for
        #: device time when modelling capacity (served_under_chaos); 0 for
        #: SLO campaigns (the engine's real cost is the service time)
        self.service_floor_s = service_floor_s
        #: per-tenant admission: None = uncontrolled (the bench's
        #: degradation-demonstration baseline)
        self.admission = (TenantAdmission(burst_s=admission_burst_s)
                          if admission_tps is not None else None)
        self.admission_tps = admission_tps
        if self.admission is not None:
            self.admission.set_rate(admission_tps)
            # the throttle burn-rate rule's good/bad pair (core/watchdog):
            # admitted vs shed totals as `admission.*` hub series
            telemetry.hub().register_admission(self.admission, "admission")
        #: transport-health probe (RealNetClient.transport_degraded on a
        #: wall node with outbound links): collapses the batch cap exactly
        #: like engine degradation — the same hook ResolverPipeline takes
        #: as transport_degraded_fn
        self._transport_degraded_fn = transport_degraded_fn
        self._pending: List[Tuple] = []
        self._version = 0
        self._committed = 0
        self._running = True
        self._batcher_task = None
        self.batches = 0
        self.depth_collapses = 0
        #: crash-stop recovery hooks (fault/recovery.py; the --crash
        #: campaign's recoverable child wires all four): a cadenced
        #: snapshot writer notified per committed batch, the boot-time
        #: recovery arc + tracker served through _status, and the disk
        #: nemesis whose injected-fault inventory explains degraded
        #: snapshot/journal cadence post-hoc
        self.snapshot_mgr = None
        self.recovery_tracker = None
        self.last_recovery: Optional[dict] = None
        self.disk_nemesis = None

    @property
    def degraded(self) -> bool:
        """Engine-degraded OR transport-degraded — either collapses the
        batch cap and tightens admission."""
        if self.engine.degraded:
            return True
        fn = self._transport_degraded_fn
        return bool(fn()) if fn is not None else False

    @property
    def address(self) -> str:
        return self.proc.address

    async def start(self) -> None:
        await self.proc.start()
        from ..sim.loop import TaskPriority

        self._batcher_task = self.sched.spawn(
            self._batcher(), TaskPriority.PROXY_COMMIT_BATCHER,
            name="chaosBatcher")
        if self.reshard_ctl is not None:
            self.reshard_ctl.start(self.sched)

    async def stop(self) -> None:
        self._running = False
        # fail any still-laned entries the batcher will never drain, so
        # no in-flight commit awaits a promise nothing owns anymore
        for _t, p, _t0, _m in self.conflict_sched.flush():
            if not p.is_set:
                p.send_error(error.operation_cancelled(""))
        if self.reshard_ctl is not None:
            self.reshard_ctl.stop()
        if self._batcher_task is not None:
            self._batcher_task.cancel()
        await self.proc.stop()

    def warmup(self) -> None:
        """AOT-compile the ladder for device-backed modes so the campaign
        never charges first-compile stalls to the SLO window; an elastic
        group additionally pre-warms standby recipient engines so a
        reshard never compiles on the serving path."""
        fn = getattr(self.engine, "warmup", None)
        if fn is not None and self.engine_mode != "oracle":
            fn()
        if self._elastic:
            self.engine.prewarm_spares(self._reshard_spares)

    def _on_reshard_complete(self, op) -> None:
        """Mid-flight adaptation after a cutover: per-tenant admission
        weights rebalance from the post-reshard heat fractions, so the
        published rate's split tracks where the load actually moved
        (server/reshard.py rebalance_admission)."""
        from ..server.reshard import rebalance_admission

        if self.admission is not None:
            rebalance_admission(self.admission, self.engine.heat)

    # -- handlers (run on the cooperative scheduler via the dispatcher) ------
    async def _commit(self, body):
        from ..sim.loop import Promise, now

        # distributed tracing: the inbound context must be captured in the
        # synchronous prefix (before the first await — core/trace.py's
        # scheduler-dispatch discipline). The server.commit span emitted on
        # every exit path carries the resolved commit VERSION as the link
        # detail the waterfall reconstruction joins batch spans on.
        ctx = current_trace_context() if g_spans.enabled else None
        t_recv = span_now() if ctx is not None else 0.0
        tenant, reads, writes, snapshot = body
        if self.admission is not None and not self.admission.admit(tenant, now()):
            if ctx is not None:
                span_event("server.commit", ctx.trace_id, t_recv, span_now(),
                           parent=ctx.parent, err="transaction_throttled",
                           tenant=tenant, Proc=self._span_proc)
            raise error.transaction_throttled(f"tenant {tenant}")
        # a key entry is a point key (bytes) or a (begin, end) RANGE pair
        # (TTL sweeps — workload.py TxnShaper "ttl_cache"): one conflict
        # range either way, so range deletes cost one interval-table row
        txn = CommitTransaction(
            read_snapshot=int(snapshot),
            read_conflict_ranges=[_key_range(k) for k in reads],
            write_conflict_ranges=[_key_range(k) for k in writes])
        p = Promise()
        #: meta cell: the batcher writes the batch's commit version here
        #: before dispatch, so even a conflicted/too-old verdict's server
        #: span can name the version that judged it. Only allocated for
        #: traced requests — the disabled path stays allocation-free.
        meta: Optional[Dict[str, int]] = {} if ctx is not None else None
        self._pending.append((txn, p, now(), meta))
        try:
            v = await p.future
        except error.FDBError as e:
            if (e.name == "transaction_conflict_predicted"
                    and self.admission is not None):
                # a pre-abort consumed no device capacity: hand the
                # admission token back so the client's fresh-version
                # retry isn't double-charged (server/ratekeeper.py)
                self.admission.refund(tenant)
            if ctx is not None:
                span_event("server.commit", ctx.trace_id, t_recv, span_now(),
                           parent=ctx.parent, err=e.name,
                           version=meta.get("version"), tenant=tenant,
                           Proc=self._span_proc)
            raise
        if ctx is not None:
            span_event("server.commit", ctx.trace_id, t_recv, span_now(),
                       parent=ctx.parent, version=int(v), tenant=tenant,
                       Proc=self._span_proc)
        return v

    async def _spans(self, _body):
        return export_spans()

    async def _status(self, _body):
        out = {
            "engine_mode": self.engine_mode,
            "committed_version": self._committed,
            "batches": self.batches,
            "depth_collapses": self.depth_collapses,
            "health": self.engine.health_stats(),
            "admission": (self.admission.as_dict()
                          if self.admission is not None else None),
            "shed_expired": self.proc.shed_expired,
        }
        if self.reshard_ctl is not None:
            out["reshard"] = self.reshard_ctl.snapshot()
        if self.conflict_sched.enabled:
            out["sched"] = self.conflict_sched.snapshot()
        loop_stats = getattr(self.inner, "loop_stats", None)
        if loop_stats is not None:
            out["loop_stats"] = dict(loop_stats)
        if self.last_recovery is not None:
            out["recovery"] = self.last_recovery
        if self.snapshot_mgr is not None:
            out["snapshots"] = dict(self.snapshot_mgr.stats)
        if self.disk_nemesis is not None:
            out["disk"] = self.disk_nemesis.summary()
        if progcache.enabled():
            out["progcache"] = progcache.active().summary()
        if blackbox.enabled():
            out["blackbox"] = blackbox.active().summary()
        return out

    # -- the serial resolve loop ---------------------------------------------
    def _refresh_admission(self) -> None:
        """Ratekeeper-style feed: the published admission rate scales by
        the degraded fraction while the supervised engine is unhealthy —
        the same signal path Ratekeeper._update_rate applies cluster-wide."""
        if self.admission is None or self.admission_tps is None:
            return
        frac = (float(SERVER_KNOBS.resolver_degraded_tps_fraction)
                if self.degraded else 1.0)
        if self._elastic and self.engine.reshard_in_flight:
            # reshard clamp (server/ratekeeper.py's tps_reshard, applied
            # at the campaign's admission point): handoff work and the
            # frozen range's queueing must not race full-rate admission
            frac = min(frac, float(SERVER_KNOBS.reshard_tps_fraction))
        self.admission.set_rate(self.admission_tps * frac)

    async def _batcher(self) -> None:
        from ..sim.loop import TaskPriority, delay, now

        committed = int(TransactionCommitResult.COMMITTED)
        hub = telemetry.hub()
        # watchdog heartbeat (core/watchdog.py): the batcher is the
        # campaign's live pulse, so alerts fire DURING the run, not at
        # the autopsy — but a full hub.sync() re-renders every
        # registered series, and the fastest burn window is 0.5 s, so
        # evaluating every ~64 ms loses nothing while keeping that host
        # work off the 4 ms measured batch cadence. One attribute check
        # per tick when the watchdog is off — the disabled path is free.
        wd_stride = max(1, round(0.064 / max(self.batch_interval_s, 1e-4)))
        ticks = 0
        while self._running:
            await delay(self.batch_interval_s, TaskPriority.PROXY_COMMIT_BATCHER)
            ticks += 1
            if hub.watchdog is not None and ticks % wd_stride == 0:
                hub.sync()
            if ticks % wd_stride == 0 and blackbox.enabled():
                # low-rate observability heartbeat onto the journal: the
                # admission/shed totals and the heat brief `cli explain`
                # joins a version against (same cadence as the watchdog —
                # one list-index check per tick when the journal is off)
                if self.admission is not None:
                    adm = self.admission
                    blackbox.record_admission(
                        "admission", sum(adm.admitted.values()),
                        sum(adm.rejected.values()),
                        rate=(float(adm.rate_limit)
                              if adm.rate_limit != float("inf") else 0.0),
                        weights=adm.weights)
                if self._heat_agg is not None:
                    blackbox.record_heat(self._heat_agg.brief())
            sched = self.conflict_sched
            if not self._pending and not sched.pending_laned():
                continue
            self._refresh_admission()
            # depth/batch collapse on degradation: a degraded engine or
            # transport serves smallest batches at depth 1 — mirroring
            # ResilientEngine's pipeline collapse — so recovery work
            # stays bounded
            cap = self.max_batch
            if self.degraded:
                cap = max(1, self.max_batch // 8)
                self.depth_collapses += 1
            plan = None
            if sched.enabled:
                if self._elastic:
                    # lanes were derived under the current shard map; an
                    # epoch flip drains and retires them so no laned
                    # transaction straddles two map generations
                    sched.notify_epoch(self.engine.emap.epoch)
                t_sel = span_now()
                plan = sched.select(self._pending, cap)
                self._pending = plan.remaining
                batch = plan.dispatch
                for (_t, p, _t0, _m), rng in plan.preaborts:
                    if not p.is_set:
                        p.send_error(error.transaction_conflict_predicted(
                            f"range {rng.hex()}"))
                if g_spans.enabled and (batch or plan.preaborts):
                    span_event("sched.select", self._version, t_sel,
                               span_now(), txns=len(batch),
                               preaborts=len(plan.preaborts),
                               Proc=self._span_proc)
                if not batch:
                    continue
            else:
                batch = self._pending[:cap]
                del self._pending[:cap]
            self._version += VERSIONS_PER_BATCH
            v = self._version
            new_oldest = max(0, v - GC_LAG_BATCHES * VERSIONS_PER_BATCH)
            txns = [t for t, _p, _t0, _m in batch]
            t_open = min(t0 for _t, _p, t0, _m in batch)
            for _t, _p, _t0, meta in batch:
                # link every traced member's request to this batch BEFORE
                # dispatch: a faulted verdict still names its version
                if meta is not None:
                    meta["version"] = v
            t0 = span_now()
            try:
                verdicts = await self.engine.resolve(txns, v, new_oldest)
            except error.FDBError as e:
                for _t, p, _t0, _m in batch:
                    if not p.is_set:
                        p.send_error(e)
                continue
            if self.service_floor_s > 0:
                # capacity model: the serial service slot is occupied for
                # the injected floor, exactly like a device program would
                await delay(self.service_floor_s,
                            TaskPriority.PROXY_COMMIT_BATCHER)
            t1 = span_now()
            self.batches += 1
            self._committed = v
            if self.snapshot_mgr is not None:
                # crash-stop recovery cadence: snapshot the engine's
                # coalesced shadow every N committed versions (never
                # raises into the serving path — fault/recovery.py)
                self.snapshot_mgr.note_batch(self.engine, v)
            if sched.enabled:
                # close the prediction loop: committed writes stamp
                # last-write versions, conflicts bump range scores, and
                # dispatched probes resolve to probe_ok/mispredict
                sched.observe_batch(txns, verdicts, v)
                if plan is not None and blackbox.enabled():
                    blackbox.record_sched(
                        plan, v, len(sched.lanes),
                        len(self._pending) + sched.pending_laned(),
                        epoch=sched.epoch)
            if not self._elastic and blackbox.enabled():
                # non-elastic: the commit server IS the resolution tier's
                # top level, so it records the batch (an elastic group
                # records its own inside _resolve_impl, with the epoch)
                blackbox.record_batch(
                    txns, v, new_oldest, verdicts,
                    engine=self.engine_mode,
                    served_by=getattr(self.engine, "state", ""),
                    witness=(self._heat_agg.attribution_for(v)
                             if self._heat_agg is not None else ()),
                    proc=self._span_proc)
            if g_spans.enabled:
                span_event("chaos.queue_wait", v, t_open, t0, txns=len(txns),
                           Proc=self._span_proc)
                span_event("chaos.resolve", v, t0, t1, txns=len(txns),
                           Proc=self._span_proc)
            for (txn, p, _t0, _m), verdict in zip(batch, verdicts):
                if p.is_set:
                    continue   # deadline-shed by the transport meanwhile
                if int(verdict) == committed:
                    p.send(v)
                elif int(verdict) == int(TransactionCommitResult.TOO_OLD):
                    p.send_error(error.transaction_too_old(""))
                else:
                    p.send_error(error.not_committed(""))


@dataclass
class NemesisConfig:
    """One seeded wall-clock campaign."""

    seed: int = 11
    engine_mode: str = "oracle"
    duration_s: float = 4.0
    #: None = the resolver_p99_budget_ms knob
    budget_ms: Optional[float] = None
    tenants: Optional[List[TenantSpec]] = None
    #: per-tenant admission on? (None = on, at 1.2x total offered)
    admission: bool = True
    admission_tps: Optional[float] = None
    #: None = the tenant_admission_burst_s knob
    admission_burst_s: Optional[float] = None
    rpc_timeout_s: float = 1.0
    max_batch: int = 48
    service_floor_s: float = 0.0
    #: network nemesis
    chaos: Optional[ChaosConfig] = None
    partitions: int = 1
    partition_s: float = 0.6
    #: device-fault window (forced failover -> swap-back round trip)
    device_faults: bool = True
    #: kill + supervised restart of a monitor.Child demo node
    kill_child: bool = True
    child_backoff_s: float = 0.3
    collect_spans: bool = True
    #: write this campaign's tail-sampled cross-process Chrome trace JSON
    #: here (None = no file; the report's trace summary is kept either way)
    trace_export: Optional[str] = None
    batch_interval_s: float = 0.004
    #: cold-start grace excluded from the SLO as a recorded window, the
    #: wall-clock analog of the sim harness's warmup_frac head-drop:
    #: first connects, first batches and cold engine paths are warmup,
    #: not steady-state serving
    warmup_frac: float = 0.15
    #: cluster watchdog (core/watchdog.py): None = the watchdog_enabled
    #: knob decides; True/False force-attach/detach for this campaign.
    #: With it on, the report gains `alerts` + `incidents` and
    #: `assert_slos` additionally requires every firing incident to be
    #: EXPLAINED (overlap an injected fault window or name a breach)
    watchdog: Optional[bool] = None
    #: extra AlertRule instances appended to the default ruleset (tests
    #: induce an unexplained incident through this)
    watchdog_extra_rules: Optional[list] = None
    #: supervisor per-dispatch watchdog override (None = the campaign
    #: default, 0.25 s). Control campaigns on co-resident CI boxes
    #: widen it so an event-loop stall can't masquerade as a device
    #: fault (see make_chaos_engine)
    dispatch_timeout_s: Optional[float] = None
    #: elastic resolution tier (server/reshard.py): the commit server
    #: resolves through an ElasticResolverGroup of supervised engines
    #: behind an epoched shard map instead of one engine
    elastic: bool = False
    #: heat-driven online resharding controller active (implies elastic)
    reshard: bool = False
    #: pre-warmed standby recipient engines (reshards never compile on
    #: the serving path while a spare is available)
    reshard_spares: int = 2
    #: assert_slos floor on executed reshards (the drift campaign's >= 2)
    min_reshards: int = 0
    #: durable black-box journal directory (core/blackbox.py): None =
    #: the resolver_blackbox knob decides; "" forces off; a path turns
    #: the journal on there — the report then carries a `blackbox`
    #: summary and `cli explain <version> REPORT.json` narrates any
    #: resolved version post-hoc
    blackbox_dir: Optional[str] = None
    #: conflict-aware admission scheduler (pipeline/scheduler.py): None =
    #: the resolver_sched knob decides; True/False force it on/off for
    #: this campaign. On, the report carries a `sched` snapshot and the
    #: fleet's submit loop retries transaction_conflict_predicted with a
    #: refreshed read version (the pre-abort contract, docs/scheduling.md)
    sched: Optional[bool] = None
    #: scenario-atlas stamp (real/scenarios.py): the named recipe this
    #: campaign instantiates. Stamped into the report, the heat/abort
    #: SIGNATURE computed while the black-box journal is still installed
    #: (a `scenario` event), and `scenario.<name>.*` telemetry gauges —
    #: None keeps the pre-atlas campaign byte-identical
    scenario: Optional[str] = None
    #: device history layout for the campaign engines ("tiered" = the
    #: sorted-run interval table, docs/perf.md "Incremental history
    #: maintenance"); None keeps the monolithic table. Oracle mode has
    #: no device table and ignores it
    history_structure: Optional[str] = None

    #: budget multiplier for device modes, the reference's, set there
    #: for device engines emulated on a CI box's CPU. The port's device
    #: modes run on the card and keep the factor as it is: chip_smoke.py
    #: reports each campaign's p99 against the budget it gives
    DEVICE_MODE_BUDGET_FACTOR = 3.0

    def resolved_budget_ms(self) -> float:
        """The asserted budget: explicit override, or the budget-knob
        product resolver_p99_budget_ms x real_chaos_budget_factor (the
        wall-clock serving point; see the knob's rationale). CPU-emulated
        device modes scale once more for their ~10 ms/batch service."""
        base = (float(self.budget_ms) if self.budget_ms is not None
                else float(SERVER_KNOBS.resolver_p99_budget_ms)
                * float(SERVER_KNOBS.real_chaos_budget_factor))
        if self.engine_mode != "oracle":
            base *= self.DEVICE_MODE_BUDGET_FACTOR
        return base

    def resolved_batch_interval_s(self) -> float:
        # device-backed modes coalesce harder: fewer, fuller batches keep
        # utilization sane against the ~10 ms CPU-emulated service time
        if self.engine_mode != "oracle":
            return max(self.batch_interval_s, 0.008)
        return self.batch_interval_s

    def default_tenants(self) -> List[TenantSpec]:
        """Default fleet sized for the in-process wall-clock ensemble: the
        transport's serial RTT is ~1 ms of CPU per request on a CI box, so
        ~110 offered txn/s keeps utilization low enough that the SLO
        measures the system, not event-loop saturation (the sweep's
        overload points raise this deliberately). Device-backed engine
        modes scale down further — their CPU-emulated service time is
        ~10x the oracle's."""
        if self.tenants is not None:
            return self.tenants
        scale = 1.0 if self.engine_mode == "oracle" else 0.4
        return [
            TenantSpec("hot", target_tps=45 * scale, s=1.2, n_keys=256),
            TenantSpec("warm", target_tps=35 * scale, s=0.9, n_keys=512),
            TenantSpec("uniform", target_tps=30 * scale, s=0.0, n_keys=1024),
        ]


@dataclass
class CampaignReport:
    cfg_seed: int
    engine_mode: str
    p99_outside_ms: float = float("nan")
    n_outside: int = 0
    p99_overall_ms: float = float("nan")
    counts: Dict[str, int] = field(default_factory=dict)
    sustained_tps: float = 0.0
    windows: List[Tuple[float, float]] = field(default_factory=list)
    engine_stats: Dict[str, int] = field(default_factory=dict)
    parity_checked: int = 0
    parity_mismatches: int = 0
    loop_stats: Optional[dict] = None
    #: keyspace heat & occupancy snapshot (core/heatmap.py) of the
    #: campaign engine — lets `cli heat REPORT.json` correlate SLO
    #: breaches with hot-key pressure after the fact
    heat: Optional[dict] = None
    admission: Optional[dict] = None
    child_restarts: int = 0
    child_crash_count: int = 0
    child_pingable_after: bool = False
    chaos_counts: Dict[str, int] = field(default_factory=dict)
    suffered: Dict[str, Dict[str, int]] = field(default_factory=dict)
    transport: Dict[str, int] = field(default_factory=dict)
    attribution: Optional[dict] = None
    #: watchdog alert lifecycle states at campaign end (core/watchdog.py)
    alerts: Optional[list] = None
    #: machine-correlated incident timeline: firing alerts grouped and
    #: matched against injected fault windows, health transitions and the
    #: trace root cause — `cli incidents REPORT.json` renders it and
    #: assert_slos requires every entry explained
    incidents: Optional[list] = None
    #: tail-sampled waterfall population (tools/trace_export.trace_summary)
    traces: Optional[dict] = None
    #: dominant segment of the worst retained trace — what an SLO-breach
    #: report names first (tools/trace_export.root_cause)
    slo_root_cause: Optional[dict] = None
    #: path of the exported Chrome trace JSON (None = not written)
    trace_file: Optional[str] = None
    #: black-box journal summary (core/blackbox.py BlackboxJournal
    #: .summary(): dir, event/segment counts, version range) — the
    #: handle `cli explain` / `cli blackbox` resolve a report through
    blackbox: Optional[dict] = None
    depth_collapses: int = 0
    shed_expired: int = 0
    #: online-resharding controller snapshot (server/reshard.py): epoch
    #: chain, executed/stalled ops with per-op blackouts — `cli shards
    #: REPORT.json` renders it
    reshard: Optional[dict] = None
    #: per-executed-reshard blackout durations as measured by the
    #: reshard.blackout trace segments (the span verification of the
    #: blackout SLO, independent of the controller's own clocks)
    reshard_span_blackouts_ms: Optional[list] = None
    #: post-reshard per-tenant admission weights (rebalance_admission)
    admission_weights: Optional[dict] = None
    #: conflict scheduler snapshot (pipeline/scheduler.py
    #: ConflictScheduler.snapshot()): decision counters, lane states,
    #: predictor hot ranges and the mispredict fraction — `cli sched
    #: REPORT.json` renders it
    sched: Optional[dict] = None
    #: scenario-atlas stamp (real/scenarios.py): which named recipe this
    #: campaign ran (None on pre-atlas / unnamed campaigns — `cli atlas`
    #: renders the absence as "—", never a KeyError)
    scenario: Optional[str] = None
    #: the scenario's heat/abort signature (real/scenarios.py
    #: build_signature): load concentration, top-range shares, verdict
    #: and witness mix — recorded into the black-box journal too
    signature: Optional[dict] = None
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        out = dict(self.__dict__)
        out["windows"] = [(round(a, 4), round(b, 4)) for a, b in self.windows]
        return out


def replay_journal_parity(journal) -> Tuple[int, int]:
    """Replay the supervised engine's journal through a CLEAN reference
    oracle: the emitted abort sets must be bit-identical to a fault-free
    engine's for the same batch stream (the DeviceNemesis contract, now on
    the wall clock). Returns (batches checked, mismatches)."""
    from ..ops.oracle import OracleConflictEngine

    clean = OracleConflictEngine()
    checked = mismatches = 0
    for version, txns, new_oldest, verdicts in journal or []:
        want = clean.resolve(list(txns), version, new_oldest)
        checked += 1
        if [int(x) for x in want] != [int(x) for x in verdicts]:
            mismatches += 1
    return checked, mismatches


def _attribute_spans(acks, budget_ms: float) -> Optional[dict]:
    """Join client acks to the server's per-batch spans by commit version:
    the server-side queue_wait/resolve segments must nest inside the
    client-observed latency (the residual is network + marshalling), and
    the p99 the SLO asserts is computed over the SAME span-joined rows."""
    by_trace = g_spans.durations_by_trace()
    rows = []
    for t0, lat, ok, version in acks:
        if not ok or version is None:
            continue
        tr = by_trace.get(version)
        if tr is None or "chaos.resolve" not in tr:
            continue
        rows.append((lat, tr.get("chaos.queue_wait", 0.0), tr["chaos.resolve"]))
    if not rows:
        return None
    from ..pipeline.latency_harness import percentile_index

    rows.sort(key=lambda r: r[0])
    lat, qw, rs = rows[percentile_index(len(rows), 0.99)]
    return {
        "n_attributed": len(rows),
        "p99": {
            "client_ms": round(lat * 1e3, 4),
            "server_queue_wait_ms": round(qw * 1e3, 4),
            "server_resolve_ms": round(rs * 1e3, 4),
            "net_residual_ms": round((lat - qw - rs) * 1e3, 4),
        },
        "budget_ms": budget_ms,
    }


async def _wait_for(predicate, timeout_s: float, interval_s: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval_s)
    return predicate()


def _child_argv(port: int) -> List[str]:
    code = ("import sys; sys.path.insert(0, %r); "
            "from foundationdb_tpu_torch.real.demo_server import main; "
            "sys.exit(main(['--port', '%d']))" % (REPO_ROOT, port))
    return [sys.executable, "-c", code]


async def _ping_child(port: int, timeout_s: float = 0.5) -> bool:
    from .demo_server import PING_TOKEN

    net = RealNetwork(name="nemesis-prober")
    try:
        r = await net.request("prober", Endpoint(f"127.0.0.1:{port}", PING_TOKEN),
                              7, timeout=timeout_s)
        return r == 7
    except (error.FDBError, ConnectionError, OSError):
        return False
    finally:
        net.close()


async def _child_chaos(cfg: NemesisConfig, report: CampaignReport,
                       log_dir: str,
                       windows_out: List[Tuple[float, float]]) -> None:
    """Process-layer nemesis: spawn a demo node under monitor.Child, kill
    it mid-campaign, and let the supervision policy (crash-loop counter +
    backoff, real/monitor.py) bring it back; prove it serves again.

    Both churn phases (initial spawn->up and kill->restarted) are recorded
    as fault windows: on a small CI box a fresh Python child's import
    storm steals a core from the serving loop, and that CPU contention IS
    part of the injected process-kill incident, not steady state."""
    from .cluster import free_ports
    from .monitor import Child, poll_children

    (port,) = free_ports(1)
    child = Child("node.chaos", _child_argv(port))
    child.backoff = cfg.child_backoff_s   # campaign-paced restart
    t_spawn = time.monotonic()
    child.spawn(log_dir)
    try:
        up = False
        for _ in range(100):
            if await _ping_child(port):
                up = True
                break
            await asyncio.sleep(0.1)
        windows_out.append((t_spawn, time.monotonic()))
        if not up:
            return   # child never served; report stays at zero restarts
        telemetry.hub().chaos_event("process_kill", port=port)
        t_kill = time.monotonic()
        child.proc.kill()
        # supervise it back up: poll_children applies the backoff + crash
        # counter; the restart must NOT be hot (due() gates on restart_at)
        deadline = time.monotonic() + cfg.child_backoff_s * 10 + 5
        while time.monotonic() < deadline:
            poll_children([child], log_dir)
            if child.restarts >= 1 and await _ping_child(port):
                report.child_pingable_after = True
                telemetry.hub().chaos_event("process_restart", port=port)
                break
            await asyncio.sleep(0.1)
        windows_out.append((t_kill, time.monotonic()))
        report.child_restarts = child.restarts
        report.child_crash_count = max(child.crash_count, report.child_crash_count)
    finally:
        child.stop()


async def _device_chaos(cfg: NemesisConfig, server: ChaosCommitServer) \
        -> List[Tuple[float, float]]:
    """Force the failover -> swap-back round trip: open a dispatch-fault
    window on the injector until the supervisor fails over to the CPU
    oracle, close it, then wait for probation to swap the device back.
    The EXCLUDED window spans the whole failover -> swap-back arc: the
    recovery (shadow rebuild, device re-warm, probation double-resolve) is
    part of the injected incident, and graceful degradation through it is
    asserted via journal parity + error accounting, not the p99 budget."""
    from ..fault.inject import FaultRates

    eng, injector = server.engine, server.injector
    t0 = time.monotonic()
    telemetry.hub().chaos_event("device_fault_window", engine=cfg.engine_mode)
    injector.rates = FaultRates(exception=0.95, hang=0, slow=0, flip=0,
                                outage=0, applied_fraction=0.5)
    await _wait_for(lambda: eng.stats["failovers"] >= 1, timeout_s=3.0)
    injector.rates = FaultRates(exception=0, hang=0, slow=0, flip=0, outage=0)
    # swap-back needs failover_min_batches on the oracle + clean probation
    # batches; traffic is still flowing, so just wait for the supervisor
    await _wait_for(lambda: eng.stats["swap_backs"] >= 1, timeout_s=8.0)
    if eng.stats["swap_backs"] >= 1:
        telemetry.hub().chaos_event("device_swap_back", engine=cfg.engine_mode)
    return [(t0, time.monotonic())]


def _campaign_blackbox(cfg: NemesisConfig):
    """This campaign's black-box journal, or None. An explicit
    cfg.blackbox_dir is used verbatim (main() already makes it
    per-campaign); the `resolver_blackbox` knob path gets a
    `<mode>_s<seed>` SUBDIRECTORY of the knob directory — campaigns
    restart versions at 0 every run, so a multi-campaign invocation
    sharing one directory would wipe every earlier campaign's journal
    (each report's blackbox.dir must survive the whole run). Either way
    the journal opens fresh=True: a re-run into the same deterministic
    path truncates the previous colliding stream."""
    proc = f"{cfg.engine_mode}-s{cfg.seed}"
    if cfg.blackbox_dir is not None:
        if not cfg.blackbox_dir:
            return None
        return blackbox.BlackboxJournal(cfg.blackbox_dir, proc=proc,
                                        fresh=True)
    base = blackbox.knob_directory()
    if base is None:
        return None
    return blackbox.BlackboxJournal(
        os.path.join(base, f"{cfg.engine_mode}_s{cfg.seed}"), proc=proc,
        fresh=True)


async def _campaign(cfg: NemesisConfig) -> CampaignReport:
    import gc

    from ..core import buggify
    from ..sim.loop import set_scheduler
    from .runtime import RealScheduler

    # a sim that ran earlier in this process (pytest co-residency) may
    # have left BUGGIFY enabled; the wall-clock campaign is a MEASURED
    # run — leaked sim fault injection (e.g. the ResilientEngine
    # dispatch-boundary site) would fail over healthy engines and charge
    # phantom incidents/latency to the system under test
    buggify_rng = buggify._rng
    buggify_was = buggify.is_enabled()
    buggify.disable()
    telemetry.reset()
    # cluster watchdog (core/watchdog.py): cfg override wins, else the
    # watchdog_enabled knob (telemetry.reset() already auto-attached a
    # default-ruleset engine when the knob is on). Campaign-attached
    # engines get the default catalog plus any test-induced extras.
    wd = None
    use_watchdog = (cfg.watchdog if cfg.watchdog is not None
                    else telemetry.hub().watchdog is not None)
    if use_watchdog:
        from ..core import watchdog as watchdog_mod

        wd = watchdog_mod.Watchdog(
            list(watchdog_mod.default_rules())
            + list(cfg.watchdog_extra_rules or []))
    telemetry.hub().attach_watchdog(wd)
    wd_budget_ms = cfg.resolved_budget_ms()
    # Defer cyclic GC for the measured window: at ~100 rps of RPC frames,
    # futures and span records, a gen-2 collection stalls the event loop
    # 20-50 ms on a CI box — latency that belongs to CPython, not the
    # system under test. Real latency-sensitive Python services ship the
    # same tuning; re-enabled (with a collect) in the finally.
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    spans_were = g_spans.enabled
    if cfg.collect_spans:
        g_spans.enabled = True
        g_spans.clear()
    # durable black-box journal (core/blackbox.py): explicit campaign dir
    # wins, else the resolver_blackbox knob; one journal per campaign so
    # `cli explain` resolves a report to exactly its own event stream
    bb = _campaign_blackbox(cfg)
    if bb is not None:
        blackbox.install(bb)
    report = CampaignReport(cfg_seed=cfg.seed, engine_mode=cfg.engine_mode)
    t_campaign = time.monotonic()
    sched = RealScheduler(seed=cfg.seed)
    set_scheduler(sched)
    run_task = asyncio.ensure_future(sched.run_async())
    tenants = cfg.default_tenants()
    offered_tps = sum(t.target_tps for t in tenants)
    admission_tps = (cfg.admission_tps if cfg.admission_tps is not None
                     else offered_tps * 1.2) if cfg.admission else None
    server = ChaosCommitServer(
        sched, engine_mode=cfg.engine_mode, admission_tps=admission_tps,
        admission_burst_s=cfg.admission_burst_s,
        batch_interval_s=cfg.resolved_batch_interval_s(),
        max_batch=cfg.max_batch,
        service_floor_s=cfg.service_floor_s,
        dispatch_timeout_s=cfg.dispatch_timeout_s,
        elastic=cfg.elastic or cfg.reshard, reshard=cfg.reshard,
        reshard_spares=cfg.reshard_spares, conflict_sched=cfg.sched,
        history_structure=cfg.history_structure)
    nemesis = NetworkNemesis(cfg.seed, cfg.chaos)
    transports: Dict[str, ChaosTransport] = {}
    versions: Dict[str, int] = {}
    log_dir = tempfile.mkdtemp(prefix="fdb_tpu_nemesis_")
    incident_windows: List[Tuple[float, float]] = []
    try:
        await server.start()
        server.warmup()
        addr = server.address
        commit_ep = Endpoint(addr, COMMIT_TOKEN)
        status_ep = Endpoint(addr, STATUS_TOKEN)
        for t in tenants:
            name = f"client-{t.name}"
            transports[t.name] = ChaosTransport(
                RealNetwork(name=name), nemesis, name=name)
            versions[t.name] = 0
        refreshing: Dict[str, bool] = {t.name: False for t in tenants}

        async def refresh_version(tenant: str) -> None:
            # a too-old verdict means this tenant's cached snapshot fell
            # behind the GC horizon (e.g. it sat out a partition); refetch
            # the committed version off the status endpoint — through the
            # SAME chaos transport, so a partitioned tenant stays stale
            # until the window heals (honest degradation)
            if refreshing.get(tenant):
                return
            refreshing[tenant] = True
            try:
                st = await transports[tenant].request(
                    f"client-{tenant}", status_ep, None,
                    timeout=cfg.rpc_timeout_s)
                versions[tenant] = max(versions[tenant],
                                       int(st["committed_version"]))
            except (error.FDBError, ConnectionError, OSError):
                pass
            finally:
                refreshing[tenant] = False

        async def submit(spec: TenantSpec, reads, writes):
            # pre-abort contract (docs/scheduling.md): the scheduler's
            # transaction_conflict_predicted reject is a fast retryable
            # error issued BEFORE device dispatch — the client refreshes
            # its read version off the status endpoint and resubmits.
            # Bounded so a mispredicting predictor cannot livelock a
            # client; exhaustion reports as a conflict (not_committed),
            # the honest verdict class for a txn the predictor deemed
            # un-commitable at every snapshot it was offered.
            for _attempt in range(8):
                try:
                    return await submit_once(spec, reads, writes)
                except error.FDBError as e:
                    if e.name != "transaction_conflict_predicted":
                        raise
                    await refresh_version(spec.name)
            raise error.not_committed("sched_retry_exhausted")

        async def submit_once(spec: TenantSpec, reads, writes):
            # distributed tracing: one context per request, attached to the
            # RPC frame by the transport and RE-ATTACHED verbatim on any
            # retry (the ambient context is re-read per send), so the
            # serving process's spans join this request's trace. Gated on
            # the span switch — with tracing off, nothing allocates.
            ctx = None
            if g_spans.enabled:
                ctx = TraceContext(trace_id=next_trace_id(),
                                   parent="client.commit")
                tok = push_trace_context(ctx)
                t_sub = span_now()
            t_wd = time.monotonic() if wd is not None else 0.0
            try:
                v = await transports[spec.name].request(
                    f"client-{spec.name}", commit_ep,
                    (spec.name, reads, writes, versions[spec.name]),
                    timeout=cfg.rpc_timeout_s)
            except error.FDBError as e:
                if ctx is not None:
                    span_event("client.commit", ctx.trace_id, t_sub,
                               span_now(), err=e.name, tenant=spec.name,
                               Proc=f"client-{spec.name}")
                if wd is not None and e.name in ("not_committed",
                                                 "transaction_too_old"):
                    # a verdict-bearing ack: it counts against the p99
                    # SLO exactly like the harness's ack population
                    # (throttles/transport failures burn other budgets)
                    watchdog_mod.record_commit_sli(
                        telemetry.hub(),
                        (time.monotonic() - t_wd) * 1e3, wd_budget_ms)
                if e.name == "transaction_too_old":
                    asyncio.ensure_future(refresh_version(spec.name))
                raise
            finally:
                if ctx is not None:
                    pop_trace_context(tok)
            if ctx is not None:
                span_event("client.commit", ctx.trace_id, t_sub, span_now(),
                           version=int(v), tenant=spec.name,
                           Proc=f"client-{spec.name}")
            if wd is not None:
                watchdog_mod.record_commit_sli(
                    telemetry.hub(), (time.monotonic() - t_wd) * 1e3,
                    wd_budget_ms)
            versions[spec.name] = max(versions[spec.name], int(v))
            return int(v)

        fleet = WorkloadFleet(tenants, submit, seed=cfg.seed,
                              duration_s=cfg.duration_s)

        async def chaos_script():
            rng = nemesis.rng
            # stagger the composed faults across the run
            await asyncio.sleep(cfg.duration_s * 0.15)
            tasks = []
            if cfg.kill_child:
                tasks.append(asyncio.ensure_future(
                    _child_chaos(cfg, report, log_dir, incident_windows)))
            for _ in range(max(0, cfg.partitions)):
                victim = tenants[rng.random_int(0, len(tenants))]
                nemesis.partition(f"client-{victim.name}", addr,
                                  cfg.partition_s)
                await asyncio.sleep(cfg.duration_s * 0.15)
            if cfg.device_faults:
                incident_windows.extend(await _device_chaos(cfg, server))
            if tasks:
                await asyncio.gather(*tasks)

        script = asyncio.ensure_future(chaos_script())
        rep = await fleet.run()
        # keep a trickle flowing until the swap-back/child scripts finish
        # (the fleet window may end mid-probation)
        while not script.done():
            try:
                await submit(tenants[-1], [b"tick/000001"], [b"tick/000001"])
            except error.FDBError:
                pass
            await asyncio.sleep(0.05)
        await script
        # post-recovery cooldown: a RECORDED steady-state phase after every
        # injected incident has closed, so the SLO always has a meaningful
        # outside-window population even when a slow recovery arc (e.g. a
        # dragged swap-back under co-resident load) ate the main window
        cooldown = WorkloadFleet(
            tenants, submit, seed=cfg.seed + 1,
            duration_s=max(1.0, cfg.duration_s * 0.3), report=rep)
        await cooldown.run()

        from ..pipeline.latency_harness import percentile_outside_windows

        # no padding: exclusion is by ack-lifetime INTERSECTION with the
        # windows (percentile_outside_windows), so an in-flight request
        # caught by a window is excluded without blanket padding
        windows = nemesis.fault_windows()
        windows += incident_windows
        #: reshard blackouts are PLANNED maintenance windows with their
        #: own SLO (per-range blackout <= reshard_blackout_budget_ms,
        #: asserted separately): acks caught inside one are excluded from
        #: the p99 like injected faults, and the watchdog correlates
        #: incidents against them under their own window kind. The
        #: `reshard_arc` records (whole plan -> cutover handoff) are
        #: correlation-only — the service keeps serving through the arc,
        #: so its latency stays IN the p99 population; only the blackout
        #: and any inline-warm window are excluded
        reshard_windows: List[dict] = (list(server.reshard_ctl.windows)
                                       if server.reshard_ctl is not None
                                       else [])
        windows += [(w["t0"], w["t1"]) for w in reshard_windows
                    if w["kind"] != "reshard_arc"]
        if cfg.warmup_frac > 0:
            # cold-start grace (see NemesisConfig.warmup_frac)
            windows.append((rep.t_start,
                            rep.t_start + cfg.duration_s * cfg.warmup_frac))
        # kinded window records: the nemesis' own (partition/stall/...)
        # plus the composed device/process arcs and the warmup grace —
        # shared by the Chrome trace export AND watchdog incident
        # correlation, so both views name the same injected faults
        window_dicts = list(nemesis.windows)
        window_dicts += [{"kind": "device_incident", "t0": a, "t1": b}
                         for a, b in incident_windows]
        window_dicts += reshard_windows
        if cfg.warmup_frac > 0:
            window_dicts.append({
                "kind": "warmup", "t0": rep.t_start,
                "t1": rep.t_start + cfg.duration_s * cfg.warmup_frac})
        if blackbox.enabled():
            # the injected fault inventory onto the journal: explain's
            # "overlapping faults" join reads the same kinded records
            # the SLO exclusion and the watchdog correlation use
            for w in window_dicts:
                blackbox.record_window(w)
        acks = rep.ack_records()
        report.windows = windows
        report.counts = rep.counts()
        report.sustained_tps = round(rep.sustained_tps(), 1)
        report.p99_outside_ms, report.n_outside = \
            percentile_outside_windows(acks, windows, p=0.99)
        from ..pipeline.latency_harness import percentile_ms

        report.p99_overall_ms = percentile_ms(
            sorted(l * 1e3 for _t, l, _ok, _v in acks), 0.99)
        report.engine_stats = dict(server.engine.stats)
        parity_fn = getattr(server.engine, "parity_check", None)
        if parity_fn is not None:
            # elastic group: every shard engine's journal — handoff
            # adoption batches included — replays through its own clean
            # oracle (server/reshard.py parity_check)
            report.parity_checked, report.parity_mismatches = parity_fn()
        else:
            report.parity_checked, report.parity_mismatches = \
                replay_journal_parity(server.engine.journal)
        heat_fn = getattr(server.engine, "heat_snapshot", None)
        if heat_fn is not None:
            report.heat = heat_fn()
        loop_stats = getattr(server.inner, "loop_stats", None)
        if loop_stats is not None:
            # quiesce the loop before reading sync accounting
            server.engine.clear(0)
            report.loop_stats = dict(loop_stats)
        report.admission = (server.admission.as_dict()
                            if server.admission is not None else None)
        if server.conflict_sched.enabled:
            report.sched = server.conflict_sched.snapshot()
        if server.reshard_ctl is not None:
            report.reshard = server.reshard_ctl.snapshot()
            if server.admission is not None:
                report.admission_weights = dict(server.admission.weights)
        report.chaos_counts = telemetry.hub().chaos_counts()
        report.suffered = {name: dict(tr.suffered)
                           for name, tr in transports.items()}
        report.transport = {
            "reconnects": sum(tr.inner.reconnects for tr in transports.values()),
            "backoff_failfasts": sum(tr.inner.backoff_failfasts
                                     for tr in transports.values()),
        }
        report.depth_collapses = server.depth_collapses
        report.shed_expired = server.proc.shed_expired
        if cfg.collect_spans:
            report.attribution = _attribute_spans(
                [r for r in acks
                 if not any(r[0] <= w1 and r[0] + r[1] >= w0
                            for w0, w1 in windows)],
                cfg.resolved_budget_ms())
            # cross-process waterfalls + tail-sampled trace export
            # (docs/observability.md "Distributed tracing"): reconstruct
            # every request's client->server->resolve waterfall, retain
            # the p99 candidates and every faulted/throttled/retried
            # request, name the worst offender's dominant segment (what
            # an assert_slos breach leads with), and write the Chrome
            # trace-event JSON with the nemesis fault windows on the
            # same timeline
            spans = list(g_spans.spans)
            if server.reshard_ctl is not None:
                # the span-verified blackout SLO: every executed reshard
                # emitted one reshard.blackout segment carrying its
                # measured freeze -> cutover duration
                report.reshard_span_blackouts_ms = [
                    rec.get("blackout_ms") for rec in spans
                    if rec.get("Name") == "reshard.blackout"]
            waterfalls = trace_export.build_waterfalls(spans)
            retained = trace_export.tail_sample(waterfalls)
            report.traces = trace_export.trace_summary(waterfalls, retained)
            report.slo_root_cause = trace_export.root_cause(retained)
            # the tail-sampled span set, shared by the journal sink and
            # the Chrome export below (one filter pass, two consumers)
            retained_spans = trace_export.spans_for_traces(spans, retained)
            if blackbox.enabled():
                # span records PAST the tail sampler onto the journal —
                # the retained waterfalls (p99 candidates + every faulted
                # request) are the per-request half explain joins batch
                # records against; unretained clean acks stay ring-only
                for rec in retained_spans:
                    blackbox.record_span(rec)
        if wd is not None:
            # final evaluation tick, then machine-correlate: every firing
            # incident must overlap an injected fault window, carry the
            # health transitions it spans, and name the dominant latency
            # segment of the worst retained trace — "slo_p99_burn firing ·
            # overlaps partition window · dominant=server_resolve"
            telemetry.hub().sync()
            breached = ("p99_budget"
                        if report.p99_outside_ms > wd_budget_ms else None)
            wd.correlate(window_dicts, root_cause=report.slo_root_cause,
                         breached_slo=breached)
            report.alerts = wd.alerts_snapshot()
            report.incidents = [i.as_dict() for i in wd.incidents]
        if cfg.collect_spans and cfg.trace_export:
            # Chrome export AFTER the watchdog correlation so incident
            # windows render on their own `watchdog` track next to the
            # nemesis fault track and the reshard arcs — one timeline
            # shows faults, incidents and reshards together
            export_windows = list(window_dicts)
            for inc in report.incidents or []:
                export_windows.append({
                    "kind": "incident", "t0": inc["t0"],
                    "t1": (inc["t1"] if inc["t1"] is not None
                           else inc["t0"]),
                    "summary": inc.get("summary")})
            doc = trace_export.chrome_trace(retained_spans, export_windows)
            os.makedirs(os.path.dirname(os.path.abspath(cfg.trace_export)),
                        exist_ok=True)
            with open(cfg.trace_export, "w") as f:
                json.dump(doc, f, default=str)
            report.trace_file = cfg.trace_export
        if cfg.scenario is not None:
            # scenario-atlas stamp (real/scenarios.py): the recipe name
            # + the heat/abort signature ride the report, the
            # `scenario.<name>.*` telemetry gauges, and — while the
            # journal is still installed — a black-box `scenario` event,
            # so post-hoc forensics can answer "which production shape
            # was this run?" from the journal alone
            from .scenarios import build_signature, publish_scenario

            report.scenario = cfg.scenario
            report.signature = build_signature(report)
            publish_scenario(cfg.scenario, report)
            if blackbox.enabled():
                blackbox.record_scenario(cfg.scenario, cfg.seed,
                                         cfg.engine_mode, report.signature)
        if bb is not None:
            report.blackbox = bb.summary()
    finally:
        if bb is not None:
            blackbox.uninstall()
        if buggify_was and buggify_rng is not None:
            buggify.enable(buggify_rng)
        if gc_was_enabled:
            gc.enable()
            gc.collect()
        for tr in transports.values():
            tr.close()
        await server.stop()
        sched.shutdown()
        run_task.cancel()
        set_scheduler(None)
        g_spans.enabled = spans_were
    report.wall_s = round(time.monotonic() - t_campaign, 2)
    return report


def run_campaign(cfg: NemesisConfig) -> CampaignReport:
    return asyncio.run(_campaign(cfg))


def assert_slos(report: CampaignReport, cfg: NemesisConfig,
                min_outside: int = 50) -> None:
    """Machine-assert every campaign SLO; raises AssertionError with the
    full report on any breach (docs/real_cluster.md, 'SLO contract')."""
    budget = cfg.resolved_budget_ms()
    ctx = json.dumps(report.as_dict(), default=str)
    if cfg.scenario is not None:
        # scenario-atlas stamp integrity (real/scenarios.py): a NAMED
        # campaign must carry its name and heat/abort signature — the
        # scenario's own budget rows (abort/throttle fractions, witness
        # mix) are then asserted by scenarios.assert_scenario_slos on top
        assert report.scenario == cfg.scenario, \
            f"scenario stamp lost ({report.scenario!r}): {ctx}"
        assert report.signature, \
            f"scenario {cfg.scenario} recorded no signature: {ctx}"
    assert report.parity_checked > 0, f"no journal batches to replay: {ctx}"
    assert report.parity_mismatches == 0, \
        f"abort sets NOT bit-identical to the clean oracle: {ctx}"
    assert report.n_outside >= min_outside, \
        (f"only {report.n_outside} acks outside fault windows "
         f"(need >= {min_outside} for a meaningful p99): {ctx}")
    root = report.slo_root_cause or {}
    assert report.p99_outside_ms <= budget, \
        (f"p99 outside injected-fault windows {report.p99_outside_ms:.3f} ms "
         f"exceeds budget {budget} ms — worst retained trace's dominant "
         f"segment: {root.get('dominant_segment')} "
         f"({root.get('dominant_ms')} ms of {root.get('client_ms')} ms, "
         f"trace {root.get('rid')} v{root.get('version')}): {ctx}")
    if cfg.device_faults:
        assert report.engine_stats.get("failovers", 0) >= 1, \
            f"no failover observed: {ctx}"
        assert report.engine_stats.get("swap_backs", 0) >= 1, \
            f"no swap-back observed: {ctx}"
    if cfg.engine_mode in ("device_loop", "mesh"):
        assert report.loop_stats is not None, f"no loop stats: {ctx}"
        assert report.loop_stats.get("blocking_syncs", 0) == 0, \
            f"{cfg.engine_mode} ring fell back to a blocking sync: {ctx}"
    if cfg.kill_child:
        assert report.child_restarts >= 1, \
            f"supervised child never restarted: {ctx}"
        assert report.child_pingable_after, \
            f"restarted child never served again: {ctx}"
    if cfg.partitions > 0:
        assert report.chaos_counts.get("partition", 0) >= 1, \
            f"no partition was injected: {ctx}"
    if cfg.reshard:
        # resharding SLOs (docs/elasticity.md "Blackout SLO"): enough
        # reshards actually EXECUTED on the live cluster, none stalled,
        # and every per-range blackout within budget — by the controller's
        # own clocks AND by the independent reshard.blackout trace segments
        rs = report.reshard or {}
        bo_budget = float(SERVER_KNOBS.reshard_blackout_budget_ms)
        assert rs.get("executed", 0) >= cfg.min_reshards, \
            (f"only {rs.get('executed', 0)} reshards executed "
             f"(need >= {cfg.min_reshards}): {ctx}")
        assert rs.get("stalled", 0) == 0, \
            f"{rs.get('stalled')} reshard(s) stalled: {ctx}"
        for op in rs.get("ops", []):
            if op.get("state") == "done":
                assert op["blackout_ms"] <= bo_budget, \
                    (f"reshard #{op['id']} ({op['kind']}) blackout "
                     f"{op['blackout_ms']:.1f} ms exceeds budget "
                     f"{bo_budget} ms: {ctx}")
        if cfg.collect_spans:
            bos = report.reshard_span_blackouts_ms or []
            assert len(bos) >= rs.get("executed", 0), \
                (f"{len(bos)} reshard.blackout trace segments for "
                 f"{rs.get('executed')} executed reshards: {ctx}")
            assert all(b is not None and b <= bo_budget for b in bos), \
                f"span-measured blackout over budget {bo_budget} ms: {ctx}"
    if report.sched is not None:
        # conflict-scheduler SLOs (docs/scheduling.md): the scheduler saw
        # the campaign's traffic, and once the probe population is big
        # enough to mean anything, the measured mispredict fraction stays
        # inside the same budget the sched_mispredict watchdog rule burns
        sc = report.sched
        assert sc["counters"].get("examined", 0) > 0, \
            f"scheduler enabled but examined no transactions: {ctx}"
        probes = (sc["counters"].get("probe_ok", 0)
                  + sc["counters"].get("mispredicts", 0))
        frac_budget = float(SERVER_KNOBS.resolver_sched_mispredict_frac)
        if probes >= 20:
            assert sc["mispredict_frac"] <= frac_budget, \
                (f"scheduler mispredict fraction "
                 f"{sc['mispredict_frac']:.3f} exceeds {frac_budget} "
                 f"over {probes} probes: {ctx}")
    if report.incidents is not None:
        # every firing incident must be EXPLAINED: it overlaps an
        # injected fault window or names a measured breach. An alert
        # with neither is the watchdog crying wolf — or a real
        # regression the campaign didn't inject; both fail the run,
        # alert name first so the log reads like a page.
        for inc in report.incidents:
            lead = (inc.get("alerts") or [{"name": "incident"}])[0]["name"]
            assert inc.get("explained"), \
                (f"{lead}: firing incident #{inc.get('id')} "
                 f"({inc.get('summary')}) is not explained by any "
                 f"injected fault window or named breach: {ctx}")
    if cfg.collect_spans:
        assert report.attribution is not None, \
            f"span attribution empty (spans not collected?): {ctx}"
        tr = report.traces or {}
        assert tr.get("retained", 0) >= 1, \
            f"tail sampling retained no traces: {ctx}"
        # the completeness contract: every retained verdict-bearing ack
        # (p99 candidate or faulted) reconstructs a COMPLETE cross-process
        # waterfall — only transport-failed requests may be client-only
        assert tr.get("retained_ack_incomplete", 0) == 0, \
            (f"{tr.get('retained_ack_incomplete')} retained ack(s) lack a "
             f"complete waterfall: {ctx}")
        assert tr.get("max_sum_err_ms", 0.0) <= 0.05, \
            (f"waterfall segments do not sum to client latency "
             f"(max err {tr.get('max_sum_err_ms')} ms): {ctx}")


# -- the diurnal drift campaign (online resharding under moving load) ---------

def drift_config(seed: int, engine_mode: str = "oracle",
                 duration_s: Optional[float] = None,
                 **kw) -> NemesisConfig:
    """The live-elasticity campaign (ROADMAP item 4, docs/elasticity.md):
    an open-loop Zipf fleet whose hot range DRIFTS across the keyspace
    over the run, served by the elastic resolver group with the
    heat-driven resharding controller active, composed with background
    NetworkNemesis faults. assert_slos then additionally requires >= 2
    reshards executed on the live cluster with every per-range blackout
    inside `reshard_blackout_budget_ms` (span-verified), on top of the
    standard p99/parity/incident contract."""
    if duration_s is None:
        duration_s = 6.0 if engine_mode == "oracle" else 10.0
    scale = 1.0 if engine_mode == "oracle" else 0.4
    n_keys = 512
    tenants = [
        # the drifting hot tenant: its Zipf head sweeps most of the pool
        # over the campaign, so the load concentration MOVES through the
        # key-sorted space and a static partition goes stale
        TenantSpec("drift", target_tps=55 * scale, s=1.2, n_keys=n_keys,
                   drift_keys_per_s=n_keys * 0.6 / duration_s),
        TenantSpec("warm", target_tps=25 * scale, s=0.9, n_keys=512),
        TenantSpec("bg", target_tps=20 * scale, s=0.0, n_keys=1024),
    ]
    kw.setdefault("watchdog", True)
    return NemesisConfig(
        seed=seed, engine_mode=engine_mode, duration_s=duration_s,
        tenants=tenants, elastic=True, reshard=True, min_reshards=2,
        partitions=1, partition_s=0.4,
        device_faults=False, kill_child=False, **kw)


# -- the bench capacity model -------------------------------------------------

def run_served_under_chaos(skews=(0.0, 0.9, 1.2), seconds: float = 4.0,
                           seed: int = 2026,
                           txns_per_user_per_sec: float = 0.5,
                           budget_ms: Optional[float] = None) -> dict:
    """The Zipf-sweep capacity model (bench.py `served_under_chaos`):
    per skew s, run the SAME overloaded wall-clock serving point with
    per-tenant admission ON and OFF under an active network nemesis. The
    capacity line: admission holds admitted-traffic p99 inside the budget
    by shedding over-rate arrivals as fast typed errors; the uncontrolled
    run queues them instead and blows the budget — measured, not assumed.
    `users_served_per_chip` converts the in-budget sustained rate at the
    reference skew (0.9) into users at `txns_per_user_per_sec`, with and
    without the nemesis."""
    if budget_ms is None:
        budget_ms = (float(SERVER_KNOBS.resolver_p99_budget_ms)
                     * float(SERVER_KNOBS.real_chaos_budget_factor))
    # capacity model point: one serial service slot of `floor_s` per batch,
    # batch cap 1 -> capacity ~= 1/(floor + tick). Offered runs ~1.3x OVER
    # capacity, so the uncontrolled queue grows without bound and p99
    # blows decisively; admission at 0.5x capacity holds M/D/1 queueing to
    # a few service times AND yields enough admitted acks that the p99 is
    # robust to a stray scheduler hiccup. The floor is the
    # wall-clock stand-in for device time — the absolute tps is transport-
    # bound and deliberately small (docs/real_cluster.md).
    floor_s, max_batch = 0.008, 1
    capacity_tps = max_batch / (floor_s + 0.0004)
    offered_total = 1.3 * capacity_tps
    admit_tps = 0.5 * capacity_tps

    def point(s: float, admission: bool, nemesis_on: bool, pseed: int) -> dict:
        tenants = [
            TenantSpec("hot", target_tps=offered_total * 0.6, s=s, n_keys=256),
            TenantSpec("bg", target_tps=offered_total * 0.4, s=0.0, n_keys=1024),
        ]
        chaos = ChaosConfig() if nemesis_on else ChaosConfig(
            latency_prob=0, drop_prob=0, reset_prob=0, handshake_stall_prob=0)
        cfg = NemesisConfig(
            seed=pseed, engine_mode="oracle", duration_s=seconds,
            budget_ms=budget_ms, tenants=tenants, admission=admission,
            admission_tps=admit_tps if admission else None,
            admission_burst_s=0.05,   # a burst must not fill the slot
            rpc_timeout_s=30.0,   # honest queueing latencies, not timeouts
            batch_interval_s=0.0004, max_batch=max_batch,
            service_floor_s=floor_s, chaos=chaos,
            partitions=1 if nemesis_on else 0, partition_s=0.4,
            device_faults=False, kill_child=False, collect_spans=False)
        rep = run_campaign(cfg)
        counts = rep.counts
        offered = max(counts.get("offered", 0), 1)
        served = counts.get("committed", 0) + counts.get("conflicted", 0)
        row = {
            "s": s,
            "admission": admission,
            "nemesis": nemesis_on,
            "p99_ms": round(rep.p99_outside_ms, 3),
            "p99_overall_ms": round(rep.p99_overall_ms, 3),
            "in_budget": bool(rep.p99_outside_ms <= budget_ms),
            "sustained_tps": rep.sustained_tps,
            "offered": offered,
            "served": served,
            "throttled_frac": round(counts.get("throttled", 0) / offered, 3),
            "abort_frac": round(counts.get("conflicted", 0) / max(served, 1), 3),
        }
        return row

    sweep = []
    for i, s in enumerate(skews):
        for admission in (True, False):
            sweep.append(point(s, admission, nemesis_on=True,
                               pseed=seed + i * 10 + int(admission)))
    ref_s = 0.9 if 0.9 in skews else skews[0]
    baseline = point(ref_s, True, nemesis_on=False, pseed=seed + 97)
    under = next(r for r in sweep if r["s"] == ref_s and r["admission"])
    users = {
        "no_nemesis": (round(baseline["sustained_tps"] / txns_per_user_per_sec)
                       if baseline["in_budget"] else 0),
        "under_nemesis": (round(under["sustained_tps"] / txns_per_user_per_sec)
                          if under["in_budget"] else 0),
    }
    return {
        "budget_ms": budget_ms,
        "txns_per_user_per_sec": txns_per_user_per_sec,
        "capacity_model_tps": round(capacity_tps),
        "offered_tps": round(offered_total),
        "admitted_tps_target": round(admit_tps),
        "sweep": sweep,
        "baseline_no_nemesis": baseline,
        "users_served_per_chip": users,
    }


#: budget multiplier for the ELASTIC serving point, the
#: DEVICE_MODE_BUDGET_FACTOR precedent: the group's host-side routing,
#: dedup cache, group-heat accounting and (while resharding) pre-copy
#: replay all share the CI box's cores with the modeled 8 ms service
#: slot, and measured run-to-run p99 swings tens of ms from co-resident
#: contention alone. A chip-adjacent deployment runs those on the donor
#: engine's own host thread; the budget prices the emulation honestly
#: instead of letting scheduler noise zero the capacity figure.
ELASTIC_BUDGET_FACTOR = 2.0


def run_served_while_resharding(seconds: float = 6.0, seed: int = 2027,
                                txns_per_user_per_sec: float = 0.5,
                                budget_ms: Optional[float] = None) -> dict:
    """The elastic capacity model (ROADMAP item 4 follow-up, bench.py
    `served_while_resharding`): the SAME modeled serving point as
    `run_served_under_chaos` (one 8 ms service slot per batch, admission
    at half capacity), but served through the elastic resolver group
    under a DRIFTING Zipf hot spot — once with the heat-driven reshard
    controller ACTIVE (ranges split/move live, admission clamps to
    `reshard_tps_fraction` while a handoff is in flight, blackouts pause
    the frozen range) and once static. `users_served_per_chip` converts
    each in-budget sustained rate into users at `txns_per_user_per_sec`,
    so the artifact answers: what does live resharding cost the serving
    capacity, measured, vs. the static 104-107 users/chip figure?"""
    if budget_ms is None:
        budget_ms = (float(SERVER_KNOBS.resolver_p99_budget_ms)
                     * float(SERVER_KNOBS.real_chaos_budget_factor)
                     * ELASTIC_BUDGET_FACTOR)
    # the run_served_under_chaos capacity point — one serial service slot
    # of floor_s per batch — but offered at 0.9x and admitted at 0.4x
    # capacity instead of its 1.3x/0.5x: the while-resharding row must
    # measure the PROTOCOL's cost (admission clamp, blackout stalls, the
    # moved history), not M/D/1 queueing amplified by CI-box CPU
    # contention at the saturation knee
    floor_s, max_batch = 0.008, 1
    capacity_tps = max_batch / (floor_s + 0.0004)
    offered_total = 0.9 * capacity_tps
    admit_tps = 0.4 * capacity_tps

    def point(reshard: bool, pseed: int) -> dict:
        n_keys = 512
        tenants = [
            # the drifting hot tenant: its Zipf head sweeps the key pool
            # so a static partition goes stale mid-run (the drift
            # campaign's load shape at the capacity point's rates)
            TenantSpec("drift", target_tps=offered_total * 0.6, s=1.2,
                       n_keys=n_keys,
                       drift_keys_per_s=n_keys * 0.6 / seconds),
            TenantSpec("bg", target_tps=offered_total * 0.4, s=0.0,
                       n_keys=1024),
        ]
        cfg = NemesisConfig(
            seed=pseed, engine_mode="oracle", duration_s=seconds,
            budget_ms=budget_ms, tenants=tenants, admission=True,
            admission_tps=admit_tps, admission_burst_s=0.05,
            rpc_timeout_s=30.0, batch_interval_s=0.0004,
            max_batch=max_batch, service_floor_s=floor_s,
            chaos=ChaosConfig(latency_prob=0, drop_prob=0, reset_prob=0,
                              handshake_stall_prob=0),
            partitions=0, device_faults=False, kill_child=False,
            collect_spans=False, elastic=True, reshard=reshard,
            reshard_spares=1)
        rep = run_campaign(cfg)
        counts = rep.counts
        offered = max(counts.get("offered", 0), 1)
        served = counts.get("committed", 0) + counts.get("conflicted", 0)
        rs = rep.reshard or {}
        return {
            "reshard": reshard,
            "p99_ms": round(rep.p99_outside_ms, 3),
            "in_budget": bool(rep.p99_outside_ms <= budget_ms),
            "sustained_tps": rep.sustained_tps,
            "offered": offered,
            "served": served,
            "throttled_frac": round(counts.get("throttled", 0) / offered, 3),
            "abort_frac": round(counts.get("conflicted", 0)
                                / max(served, 1), 3),
            "reshards_executed": rs.get("executed", 0),
            "reshards_stalled": rs.get("stalled", 0),
            "blackout_ms_max": rs.get("blackout_ms_max", 0.0),
            "final_shards": (rs.get("shard_map") or {}).get("n_shards"),
            "parity_checked": rep.parity_checked,
            "parity_mismatches": rep.parity_mismatches,
        }

    static = point(False, seed)
    resharding = point(True, seed + 1)

    def users(row: dict) -> int:
        return (round(row["sustained_tps"] / txns_per_user_per_sec)
                if row["in_budget"] else 0)

    return {
        "budget_ms": budget_ms,
        "txns_per_user_per_sec": txns_per_user_per_sec,
        "capacity_model_tps": round(capacity_tps),
        "offered_tps": round(offered_total),
        "admitted_tps_target": round(admit_tps),
        "static": static,
        "resharding": resharding,
        "users_served_per_chip": {
            "static": users(static),
            "while_resharding": users(resharding),
        },
    }


def run_conflict_scheduling(seconds: float = 4.0, seed: int = 3026) -> dict:
    """The conflict-scheduling A/B (bench.py `conflict_scheduling`): the
    SAME contended Zipf-1.2 wall-clock serving point with the conflict
    scheduler OFF and ON, same seeds, same fleet. The claim under test
    (docs/scheduling.md): pre-abort + refresh-and-retry plus hot-range
    serialization lanes at least HALVE the abort fraction at equal-or-
    better served txn/s — aborts become fast early rejects the client
    retries at a fresh snapshot instead of wasted device verdicts. Both
    rows replay their engine journal through a clean serial oracle: the
    scheduler reorders ADMISSION, never resolution, so parity must hold
    bit-for-bit in the scheduled order too."""

    def point(sched_on: bool, pseed: int) -> dict:
        # a contention-dominated point, NOT a capacity-dominated one: a
        # small hot key pool under Zipf 1.2 makes write-write collisions
        # the limiting factor while the serving slot stays uncongested,
        # so abort_frac measures conflict handling, not queueing
        tenants = [
            TenantSpec("hot", target_tps=200, s=1.2, n_keys=16),
            TenantSpec("bg", target_tps=25, s=0.0, n_keys=1024),
        ]
        cfg = NemesisConfig(
            seed=pseed, engine_mode="oracle", duration_s=seconds,
            tenants=tenants, admission=True,
            rpc_timeout_s=30.0, batch_interval_s=0.002, max_batch=48,
            chaos=ChaosConfig(latency_prob=0, drop_prob=0, reset_prob=0,
                              handshake_stall_prob=0),
            partitions=0, device_faults=False, kill_child=False,
            collect_spans=False, sched=sched_on)
        rep = run_campaign(cfg)
        counts = rep.counts
        offered = max(counts.get("offered", 0), 1)
        served = counts.get("committed", 0) + counts.get("conflicted", 0)
        row = {
            "sched": sched_on,
            "p99_ms": round(rep.p99_outside_ms, 3),
            "sustained_tps": rep.sustained_tps,
            "offered": offered,
            "committed": counts.get("committed", 0),
            "conflicted": counts.get("conflicted", 0),
            "served": served,
            "served_tps": round(served / max(seconds, 1e-9), 1),
            "throttled_frac": round(counts.get("throttled", 0) / offered, 3),
            "abort_frac": round(counts.get("conflicted", 0)
                                / max(served, 1), 4),
            "parity_checked": rep.parity_checked,
            "parity_mismatches": rep.parity_mismatches,
        }
        if rep.sched is not None:
            sc = rep.sched["counters"]
            row["preaborts"] = sc.get("preaborts", 0)
            row["laned"] = sc.get("laned", 0)
            row["deferred"] = sc.get("deferred", 0)
            row["probes"] = sc.get("probes", 0)
            row["mispredict_frac"] = rep.sched["mispredict_frac"]
        return row

    # same seed both arms: identical arrival processes, so the delta is
    # the scheduler, not sampling noise
    off = point(False, seed)
    on = point(True, seed)
    reduction = (1.0 - on["abort_frac"] / off["abort_frac"]
                 if off["abort_frac"] > 0 else 0.0)
    return {
        "off": off,
        "on": on,
        "abort_frac_reduction": round(reduction, 3),
        "served_tps_ratio": round(on["served_tps"]
                                  / max(off["served_tps"], 1e-9), 3),
        "goal_met": bool(
            reduction >= 0.5
            and on["served_tps"] >= off["served_tps"] * 0.98
            and on["parity_mismatches"] == 0
            and off["parity_mismatches"] == 0),
    }


# -- solo traced commit server (the 2-process trace smoke's child) ------------

async def _serve_commit(port: int) -> None:
    """Run ONE traced ChaosCommitServer solo: the child half of `make
    trace-smoke`'s 2-OS-process cluster. Spans are on and the process
    names itself, so fetched span rings identify their recorder."""
    from ..core.trace import set_process_name, set_span_collection
    from ..sim.loop import set_scheduler
    from .runtime import RealScheduler

    set_span_collection(True)
    set_process_name(f"commit-server:{port}")
    sched = RealScheduler(seed=0)
    set_scheduler(sched)
    run_task = asyncio.ensure_future(sched.run_async())
    server = ChaosCommitServer(sched, engine_mode="oracle", port=port)
    try:
        await server.start()
        print(f"listening on {server.address}", flush=True)
        while True:
            await asyncio.sleep(3600)
    finally:
        await server.stop()
        sched.shutdown()
        run_task.cancel()
        set_scheduler(None)


# -- crash-stop recovery campaign (fault/recovery.py; --crash) ----------------

@dataclass
class CrashConfig:
    """One seeded crash-restart campaign: a RECOVERABLE commit-server
    child (journal + snapshots + progcache in a durable directory) is
    killed -9 mid-load under background disk faults, supervised back up
    by monitor.Child, and must recover — snapshot + differential journal
    replay + progcache rewarm — inside the blackout budget, then serve
    NEW commits that continue the pre-crash history bit-for-bit."""

    seed: int = 11
    engine_mode: str = "torch"
    #: durable directory (bbox-*.seg + snap-*.snap + progcache/);
    #: None = a per-campaign tempdir. Re-runs wipe the journal and
    #: snapshots (versions restart at 0) but KEEP progcache/ on purpose:
    #: rewarm-from-cache is the steady state the budget is sized for.
    datadir: Optional[str] = None
    #: pre-kill serving phase (seeds snapshots); the port keeps serving
    #: past it until the child has written a snapshot, at most
    #: boot_timeout_s more (_serve_until_snapshot)
    warm_s: float = 3.0
    post_s: float = 1.5       #: post-recovery serving phase
    #: extra bounded wait for the FIRST post-restart commit before the
    #: post_s window starts counting: the load client's reconnect
    #: backoff after the kill (or the first commit faulting in a program
    #: the rewarm's used-only set skipped) can otherwise eat a fixed
    #: window whole and fail the serving SLO on a healthy node
    post_grace_s: float = 10.0
    rate_tps: float = 120.0
    #: None = the resolver_recovery_budget_ms knob
    budget_ms: Optional[float] = None
    #: per-durable-write disk-fault probability: fsync stalls on the
    #: journal (lossless, so the parity proof holds), torn tails on
    #: snapshots (recovery falls back), rot/ENOSPC on the progcache
    #: (poisoned entries quarantine to a compile)
    disk_prob: float = 0.05
    child_backoff_s: float = 0.3
    #: first-boot serve deadline: a cold device-backed child AOT-compiles
    #: its ladder before listening (restarts rewarm from the progcache)
    boot_timeout_s: float = 240.0
    #: the torch device the child's card-mode engine runs on (None: the
    #: card, raising in the child where there is none)
    device: Optional[str] = None

    def resolved_budget_ms(self) -> float:
        base = (float(SERVER_KNOBS.resolver_recovery_budget_ms)
                if self.budget_ms is None else float(self.budget_ms))
        if self.engine_mode not in ("oracle",):
            # device-backed replay re-resolves the suffix through the
            # CPU-emulated device path — same rationale as the p99
            # budget's device-mode factor
            base *= NemesisConfig.DEVICE_MODE_BUDGET_FACTOR
        return base


def crash_config(seed: int, engine_mode: str = "torch", **kw) -> CrashConfig:
    """The crash campaign point for (seed, engine_mode) (`main --crash`)."""
    if engine_mode == "device_loop":
        kw.setdefault("warm_s", 5.0)
    return CrashConfig(seed=seed, engine_mode=engine_mode, **kw)


def _crash_child_argv(port: int, datadir: str, engine_mode: str,
                      seed: int, disk_prob: float,
                      device: Optional[str] = None) -> List[str]:
    argv = ["--serve-recover", str(port), "--datadir", datadir,
            "--child-engine", engine_mode, "--recovery-seed", str(seed),
            "--disk-prob", str(disk_prob)]
    if device is not None:
        argv += ["--device", str(device)]
    code = ("import sys; sys.path.insert(0, %r); "
            "from foundationdb_tpu_torch.real.nemesis import main; "
            "sys.exit(main(%r))" % (REPO_ROOT, argv))
    return [sys.executable, "-c", code]


def _snapshot_written(status: dict) -> bool:
    """Whether a child's status shows a snapshot written to disk."""
    return int((status.get("snapshots") or {}).get("written", 0)) >= 1


async def _serve_until_snapshot(port: int, status: dict, timeout_s: float,
                                poll_s: float = 0.1) -> Tuple[dict, float]:
    """After the pre-kill window: while the child's status shows no
    snapshot written, let the load run on and ask again every `poll_s`,
    for at most `timeout_s`. Returns (the last status, the seconds past
    the window). The snapshot cadence counts committed versions, so on a
    slow host the window alone may end before the first snapshot; where
    the first status already shows one, nothing more runs and the
    campaign's sequence is the reference's."""
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    while not _snapshot_written(status) and time.monotonic() < deadline:
        await asyncio.sleep(poll_s)
        status = await _child_rpc(port, STATUS_TOKEN) or {}
    return status, round(time.monotonic() - t0, 3)


async def _child_rpc(port: int, token: str, timeout_s: float = 1.5):
    """One status/span RPC at a (possibly dead) child; None on any
    transport or typed failure — the restart poll's probe."""
    net = RealNetwork(name="crash-prober")
    try:
        return await net.request(
            "prober", Endpoint(f"127.0.0.1:{port}", token), None,
            timeout=timeout_s)
    except (error.FDBError, ConnectionError, OSError):
        return None
    finally:
        net.close()


async def _serve_recoverable(port: int, datadir: str, engine_mode: str,
                             seed: int, disk_prob: float,
                             device: Optional[str] = None) -> None:
    """The --crash campaign's child: a ChaosCommitServer that RECOVERS
    before it serves. Every boot replays the durable directory — newest
    readable snapshot, then the journal's batch suffix at original
    versions — through fault/recovery, restores the version clock past
    everything recovered, then serves with the journal continuing in
    place (fresh=False) and fsync_interval=1: an acked batch is durable
    before its verdict leaves the process, the crash-window contract
    (docs/observability.md) the parent's parity replay relies on."""
    from ..fault import recovery
    from ..fault.inject import DiskFaultRates
    from ..core.trace import set_process_name, set_span_collection
    from ..sim.loop import TaskPriority, set_scheduler
    from .chaos import DiskNemesis
    from .runtime import RealScheduler

    set_span_collection(True)
    proc = f"crash-server:{port}"
    set_process_name(proc)
    disk = None
    if disk_prob > 0:
        p = float(disk_prob)
        disk = DiskNemesis(
            seed, rates=DiskFaultRates(stall=p, stall_ms=5.0),
            surface_rates={
                "snapshot": DiskFaultRates(stall=p, stall_ms=5.0, torn=p),
                "progcache": DiskFaultRates(enospc=p / 2, rot=p / 2),
            })
    blackbox.install(blackbox.BlackboxJournal(
        datadir, proc=proc, fresh=False, fsync_interval=1, disk=disk))
    progcache.install(progcache.ProgramCache(
        os.path.join(datadir, "progcache"), disk=disk))
    sched = RealScheduler(seed=seed)
    set_scheduler(sched)
    run_task = asyncio.ensure_future(sched.run_async())
    server = ChaosCommitServer(sched, engine_mode=engine_mode, port=port,
                               device=device)
    server.disk_nemesis = disk
    tracker = recovery.RecoveryTracker(name=f"crash{port}")
    server.recovery_tracker = tracker
    # recover() resolves replayed batches through the supervised engine,
    # whose sim-loop futures can only be awaited from a task on the
    # cooperative scheduler — bridge the result back to asyncio
    done: asyncio.Future = asyncio.get_event_loop().create_future()

    async def _do_recover() -> None:
        try:
            r = await recovery.recover(server.engine, datadir,
                                       tracker=tracker, proc=proc)
            done.set_result(r)
        except Exception as e:  # pragma: no cover - surfaced to boot log
            done.set_exception(e)

    sched.spawn(_do_recover(), TaskPriority.PROXY_COMMIT_BATCHER,
                name="recover")
    res = await done
    server.last_recovery = res.as_dict()
    server._version = server._committed = max(0, int(res.recovered_version))
    if res.mode == recovery.MODE_COLD and engine_mode != "oracle":
        # first boot: AOT-compile the ladder — and thereby seed the
        # progcache — OFF the serving path; restarts rewarm during replay
        server.warmup()
    server.snapshot_mgr = recovery.SnapshotManager(datadir, disk=disk,
                                                   proc=proc)
    try:
        await server.start()
        print(f"listening on {server.address} recovered={res.mode} "
              f"v={res.recovered_version}", flush=True)
        while True:
            await asyncio.sleep(3600)
    finally:
        await server.stop()
        sched.shutdown()
        run_task.cancel()
        set_scheduler(None)


async def _crash_load(port: int, rng, rate_tps: float,
                      stats: Dict[str, int], vcache: List[int],
                      net: RealNetwork, stop: List[bool]) -> None:
    """Open-loop commit stream at the recoverable child: mixed
    read/write conflict ranges over a small hot keyspace, version cache
    refreshed off the status endpoint on too-old. Runs THROUGH the kill
    window — the dead stretch shows up as transport errors, exactly the
    client view of the blackout."""
    ep = Endpoint(f"127.0.0.1:{port}", COMMIT_TOKEN)
    sep = Endpoint(f"127.0.0.1:{port}", STATUS_TOKEN)
    interval = 1.0 / max(rate_tps, 1.0)
    while not stop[0]:
        ks = [b"ck%04d" % rng.random_int(0, 256) for _ in range(3)]
        body = ("crash", (ks[0],), tuple(ks[1:]), vcache[0])
        try:
            v = await net.request("crash-client", ep, body, timeout=1.0)
            vcache[0] = max(vcache[0], int(v))
            stats["committed"] = stats.get("committed", 0) + 1
        except error.FDBError as e:
            stats[e.name] = stats.get(e.name, 0) + 1
            if e.name == "transaction_too_old":
                try:
                    st = await net.request("crash-client", sep, None,
                                           timeout=1.0)
                    vcache[0] = max(vcache[0],
                                    int(st["committed_version"]))
                except (error.FDBError, ConnectionError, OSError):
                    pass
        except (ConnectionError, OSError):
            stats["transport_errors"] = stats.get("transport_errors", 0) + 1
        await asyncio.sleep(interval)


def replay_events_parity(events) -> Tuple[int, int]:
    """Replay EVERY batch the child's durable journal retained — both
    boots, across the crash — through a clean serial oracle. With the
    journal surface lossless (stall-only faults, fsync_interval=1) the
    retained stream is exactly what the server acked, so the recovered
    engine's post-restart verdicts must CONTINUE the pre-crash history
    bit-for-bit. Returns (batches checked, mismatches)."""
    from ..ops.oracle import OracleConflictEngine

    clean = OracleConflictEngine()
    checked = mismatches = 0
    for e in events:
        if e.kind != "batch":
            continue
        p = e.payload
        want = clean.resolve(list(p.txns), int(p.version),
                             int(p.new_oldest))
        checked += 1
        if [int(x) for x in want] != [int(x) for x in p.verdicts]:
            mismatches += 1
    return checked, mismatches


async def _crash_campaign(cfg: CrashConfig) -> dict:
    from ..core.rng import DeterministicRandom
    from .cluster import free_ports
    from .monitor import Child, poll_children

    telemetry.reset()
    datadir = cfg.datadir or os.path.join(
        tempfile.mkdtemp(prefix="fdb_tpu_crash_"), "node0")
    os.makedirs(datadir, exist_ok=True)
    # deterministic re-run: drop the previous run's journal + snapshots
    # (versions restart at 0) but KEEP progcache/ — the bench's
    # rewarm-from-cache point measures exactly this surviving directory
    for n in os.listdir(datadir):
        if n.startswith(("bbox-", "snap-")):
            try:
                os.remove(os.path.join(datadir, n))
            except OSError:
                pass
    (port,) = free_ports(1)
    log_dir = os.path.join(datadir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    rng = DeterministicRandom(cfg.seed * 7919 + 17)
    report: dict = {"engine_mode": cfg.engine_mode, "seed": cfg.seed,
                    "datadir": datadir,
                    "budget_ms": cfg.resolved_budget_ms(),
                    "child_up": False, "child_restarts": 0,
                    "child_pingable_after": False}
    child = Child("node.crash", _crash_child_argv(
        port, datadir, cfg.engine_mode, cfg.seed, cfg.disk_prob,
        device=cfg.device))
    child.backoff = cfg.child_backoff_s
    child.spawn(log_dir)
    net = RealNetwork(name="crash-driver")
    stats: Dict[str, int] = {}
    vcache = [0]
    stop = [False]
    load_task = None
    try:
        deadline = time.monotonic() + cfg.boot_timeout_s
        while time.monotonic() < deadline:
            if await _child_rpc(port, STATUS_TOKEN) is not None:
                report["child_up"] = True
                break
            await asyncio.sleep(0.2)
        if not report["child_up"]:
            return report
        load_task = asyncio.ensure_future(_crash_load(
            port, rng, cfg.rate_tps, stats, vcache, net, stop))
        # pre-kill serving phase: commits flow, snapshots cadence out
        await asyncio.sleep(cfg.warm_s)
        st = await _child_rpc(port, STATUS_TOKEN) or {}
        st, report["pre_kill_extra_s"] = await _serve_until_snapshot(
            port, st, cfg.boot_timeout_s)
        report["committed_before_kill"] = int(
            st.get("committed_version", 0))
        report["snapshots_before_kill"] = dict(st.get("snapshots") or {})
        telemetry.hub().chaos_event("process_kill", port=port)
        t_kill = time.monotonic()
        child.proc.kill()
        # supervise it back up (backoff + crash counter, real/monitor.py);
        # the restarted child RECOVERS before it listens, so the first
        # successful status is already recovered + serving
        st2 = None
        deadline = time.monotonic() + cfg.boot_timeout_s
        while time.monotonic() < deadline:
            poll_children([child], log_dir)
            if child.restarts >= 1:
                st2 = await _child_rpc(port, STATUS_TOKEN)
                if st2 is not None:
                    break
            await asyncio.sleep(0.1)
        report["child_restarts"] = child.restarts
        report["restart_serve_s"] = round(time.monotonic() - t_kill, 3)
        if st2 is None:
            return report
        telemetry.hub().chaos_event("process_restart", port=port)
        report["child_pingable_after"] = True
        report["recovery"] = st2.get("recovery")
        # post-recovery serving phase: the recovered node must take NEW
        # traffic past everything it recovered
        vcache[0] = max(vcache[0], int(st2.get("committed_version", 0)))
        committed_at_restart = stats.get("committed", 0)
        # evidence-driven post window: wait (bounded) for the first NEW
        # commit to land, then give the load the full post_s to run —
        # the SLO is "the recovered node serves", not "it served within
        # an arbitrary fixed sleep of the restart"
        grace = time.monotonic() + cfg.post_grace_s
        while (stats.get("committed", 0) == committed_at_restart
               and time.monotonic() < grace):
            await asyncio.sleep(0.1)
        await asyncio.sleep(cfg.post_s)
        stop[0] = True
        await load_task
        load_task = None
        st3 = await _child_rpc(port, STATUS_TOKEN) or {}
        report["committed_after"] = int(st3.get("committed_version", 0))
        report["committed_post_restart"] = (stats.get("committed", 0)
                                            - committed_at_restart)
        report["snapshots"] = dict(st3.get("snapshots") or {})
        report["blackbox"] = st3.get("blackbox")
        report["disk"] = st3.get("disk")
        report["progcache"] = st3.get("progcache")
        # span-verified blackout: the restarted process's OWN span ring,
        # fetched over RPC — independent of the recovery code's clocks
        spans = await _child_rpc(port, SPANS_TOKEN)
        report["recovery_span_blackouts_ms"] = [
            r.get("blackout_ms") for r in (spans or {}).get("spans", ())
            if r.get("Name") == "recovery.blackout"
            and r.get("blackout_ms") is not None]
    finally:
        stop[0] = True
        if load_task is not None:
            try:
                await load_task
            except Exception:
                pass
        child.stop()
        net.close()
    report["load"] = dict(stats)
    # the durable copy of the arc + bit-parity through a clean oracle
    events = blackbox.read_journal(datadir)
    report["recovery_events"] = [dict(vars(e.payload)) for e in events
                                 if e.kind == "recovery"]
    report["snapshot_events"] = sum(1 for e in events
                                    if e.kind == "snapshot")
    checked, mismatches = replay_events_parity(events)
    report["parity_checked"] = checked
    report["parity_mismatches"] = mismatches
    report["chaos_counts"] = telemetry.hub().chaos_counts()
    return report


def run_crash_campaign(cfg: CrashConfig) -> dict:
    t0 = time.monotonic()
    rep = asyncio.run(_crash_campaign(cfg))
    rep["wall_s"] = round(time.monotonic() - t0, 3)
    return rep


def assert_crash_slos(report: dict, cfg: CrashConfig) -> None:
    """Machine-assert the crash-restart contract — never by eyeball."""
    ctx = f"(engine={cfg.engine_mode} seed={cfg.seed})"
    assert report.get("child_up"), f"child never served {ctx}"
    assert report.get("child_restarts", 0) >= 1, \
        f"child was not supervised back up {ctx}"
    assert report.get("child_pingable_after"), \
        f"restarted child never answered status {ctx}"
    assert report.get("committed_after", 0) > \
        report.get("committed_before_kill", 0), \
        f"recovered child served no new commits {ctx}"
    assert report.get("committed_post_restart", 0) > 0, \
        f"no client commit succeeded post-recovery {ctx}"
    rec = report.get("recovery") or {}
    assert not rec.get("error"), \
        f"recovery errored: {rec.get('error')} {ctx}"
    assert rec.get("mode") == "complete" and rec.get("coverage_ok"), \
        f"recovery not provably complete: {rec} {ctx}"
    assert rec.get("verdict_mismatches", 1) == 0, \
        f"recovery replay diverged: {rec} {ctx}"
    assert (rec.get("snapshot_version", -1) >= 0
            or rec.get("replayed_batches", 0) > 0), \
        f"recovery recovered nothing durable: {rec} {ctx}"
    budget = cfg.resolved_budget_ms()
    assert rec.get("blackout_ms", budget + 1) <= budget, \
        (f"recovery blackout {rec.get('blackout_ms')}ms "
         f"> budget {budget}ms {ctx}")
    blk = report.get("recovery_span_blackouts_ms") or []
    assert blk, f"no recovery.blackout span fetched from the child {ctx}"
    assert max(blk) <= budget, \
        f"span-verified blackout {max(blk)}ms > budget {budget}ms {ctx}"
    assert report.get("snapshot_events", 0) >= 1, \
        f"no snapshot ever cadenced out {ctx}"
    assert report.get("parity_checked", 0) > 0, \
        f"no journal batches to replay {ctx}"
    assert report.get("parity_mismatches", 0) == 0, \
        (f"{report.get('parity_mismatches')} parity mismatches across "
         f"the crash {ctx}")
    # disk incidents explained: the journal surface must have stayed
    # LOSSLESS (the parity proof's precondition — stall-only faults),
    # and every injected fault is inventoried in the report
    bb = report.get("blackbox") or {}
    assert int(bb.get("shed_events", 0)) == 0 \
        and not bb.get("durability_gap"), \
        f"journal lost records under disk faults: {bb} {ctx}"


# -- CLI ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="wall-clock chaos campaign with machine-asserted SLOs")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--base-seed", type=int, default=11)
    ap.add_argument("--engine-modes", default="torch,device_loop",
                    help="comma list of oracle|torch|device_loop|mesh (the "
                         "card modes run on the card and raise without one)")
    ap.add_argument("--duration", type=float, default=None,
                    help="campaign seconds (default 4.0; --drift defaults "
                         "6.0 oracle / 10.0 device-backed)")
    ap.add_argument("--budget-ms", type=float, default=None,
                    help="explicit p99 budget; default is the knob product "
                         "resolver_p99_budget_ms x real_chaos_budget_factor "
                         "(the wall-clock serving point — see the factor "
                         "knob's rationale in core/knobs.py)")
    ap.add_argument("--sweep", action="store_true",
                    help="also run the served_under_chaos Zipf sweep")
    ap.add_argument("--json", default=None, help="write reports to this file")
    ap.add_argument("--trace-dir", default=None,
                    help="write each campaign's tail-sampled cross-process "
                         "Chrome trace JSON into this directory "
                         "(chrome://tracing / Perfetto loadable)")
    ap.add_argument("--blackbox-dir", default=None,
                    help="write each campaign's durable black-box journal "
                         "into a per-campaign subdirectory of this path "
                         "(core/blackbox.py; `cli explain <version> "
                         "REPORT.json` narrates any resolved version "
                         "post-hoc, `cli blackbox replay` diffs a window "
                         "against the serial oracle)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run a traced commit server solo on PORT "
                         "(the trace-smoke child process) and never return")
    ap.add_argument("--crash", action="store_true",
                    help="run the crash-restart campaign instead of the "
                         "fault campaign: a recoverable child (journal + "
                         "snapshots + progcache) killed -9 mid-load under "
                         "disk faults, supervised back up, and required "
                         "to recover inside resolver_recovery_budget_ms "
                         "with bit-identical replay parity across the "
                         "crash (docs/fault_tolerance.md)")
    ap.add_argument("--serve-recover", type=int, default=None,
                    metavar="PORT",
                    help="run the --crash campaign's RECOVERABLE commit "
                         "server solo on PORT (recovers --datadir before "
                         "listening) and never return")
    ap.add_argument("--datadir", default=None,
                    help="--serve-recover / --crash durable directory")
    ap.add_argument("--child-engine", default="torch",
                    help="--serve-recover engine mode")
    ap.add_argument("--recovery-seed", type=int, default=11,
                    help="--serve-recover nemesis seed")
    ap.add_argument("--device", default=None,
                    help="--serve-recover: the torch device of a card-mode "
                         "engine (default: the card)")
    ap.add_argument("--disk-prob", type=float, default=0.05,
                    help="--serve-recover per-write disk-fault "
                         "probability")
    ap.add_argument("--drift", action="store_true",
                    help="run the diurnal drift campaign instead of the "
                         "fault campaign: elastic resolver group + "
                         "heat-driven online resharding under a drifting "
                         "Zipf fleet; assert_slos additionally requires "
                         ">= 2 executed reshards with every blackout "
                         "inside reshard_blackout_budget_ms "
                         "(docs/elasticity.md)")
    ap.add_argument("--watchdog", action="store_true",
                    help="attach the cluster watchdog (core/watchdog.py): "
                         "live burn-rate/anomaly alerts during the "
                         "campaign, incident timelines in the report "
                         "(`cli incidents REPORT.json`), and assert_slos "
                         "additionally requires every firing incident "
                         "explained by an injected fault window")
    args = ap.parse_args(argv)
    if args.serve is not None:
        try:
            asyncio.run(_serve_commit(args.serve))
        except KeyboardInterrupt:
            pass
        return 0

    if args.serve_recover is not None:
        if not args.datadir:
            print("--serve-recover requires --datadir", file=sys.stderr)
            return 2
        if args.device == "cpu" and args.child_engine != "oracle":
            import torch

            # as a node: the child shares the host's cores with its parent
            torch.set_num_threads(1)
        try:
            asyncio.run(_serve_recoverable(
                args.serve_recover, args.datadir, args.child_engine,
                args.recovery_seed, args.disk_prob, device=args.device))
        except KeyboardInterrupt:
            pass
        return 0

    modes = [m for m in args.engine_modes.split(",") if m]
    reports, failures = [], 0
    for mode in modes:
        # device-backed modes run longer: their fault windows (a rewarm
        # replays the shadow batch by batch) eat more of the run, and the SLO
        # needs enough outside-window samples for a meaningful p99
        base_duration = 4.0 if args.duration is None else args.duration
        duration = (base_duration if mode == "oracle"
                    else max(base_duration, 8.0))
        for i in range(args.seeds):
            seed = args.base_seed + i
            if args.crash:
                ccfg = crash_config(
                    seed, engine_mode=mode, budget_ms=args.budget_ms,
                    datadir=(os.path.join(args.blackbox_dir,
                                          f"crash_{mode}_s{seed}")
                             if args.blackbox_dir else None),
                    disk_prob=args.disk_prob)
                print(f"crash campaign: engine={mode} seed={seed} ...",
                      flush=True)
                rep_c = run_crash_campaign(ccfg)
                reports.append(rep_c)
                try:
                    assert_crash_slos(rep_c, ccfg)
                    recd = rep_c.get("recovery") or {}
                    blk = rep_c.get("recovery_span_blackouts_ms") or [0.0]
                    print(f"  OK  blackout={recd.get('blackout_ms')}ms "
                          f"(span {max(blk):.1f}ms, budget "
                          f"{ccfg.resolved_budget_ms():.0f}ms) "
                          f"mode={recd.get('mode')} "
                          f"replayed={recd.get('replayed_batches')} "
                          f"snap_v={recd.get('snapshot_version')} "
                          f"progcache_hits={recd.get('progcache_hits')} "
                          f"parity={rep_c.get('parity_checked')} "
                          f"restarts={rep_c.get('child_restarts')}",
                          flush=True)
                except AssertionError as e:
                    failures += 1
                    print(f"  SLO FAILED: {e}", file=sys.stderr,
                          flush=True)
                continue
            trace_path = (os.path.join(args.trace_dir,
                                       f"trace_{mode}_s{seed}.json")
                          if args.trace_dir else None)
            bb_dir = (os.path.join(args.blackbox_dir, f"{mode}_s{seed}")
                      if args.blackbox_dir else None)
            if args.drift:
                cfg = drift_config(seed, engine_mode=mode,
                                   duration_s=args.duration,
                                   budget_ms=args.budget_ms,
                                   trace_export=trace_path,
                                   blackbox_dir=bb_dir,
                                   watchdog=True if args.watchdog else None)
            else:
                cfg = NemesisConfig(seed=seed, engine_mode=mode,
                                    duration_s=duration,
                                    budget_ms=args.budget_ms,
                                    trace_export=trace_path,
                                    blackbox_dir=bb_dir,
                                    watchdog=True if args.watchdog else None)
            print(f"campaign: engine={mode} seed={seed}"
                  + (" [drift]" if args.drift else "") + " ...", flush=True)
            rep = run_campaign(cfg)
            reports.append(rep.as_dict())
            if rep.trace_file:
                # schema-check every export right here: a campaign whose
                # trace JSON would not load is a failed campaign
                with open(rep.trace_file) as f:
                    n_events = trace_export.validate_chrome_trace(json.load(f))
                tr = rep.traces or {}
                print(f"  traces -> {rep.trace_file} ({n_events} events, "
                      f"{tr.get('retained')} retained of "
                      f"{tr.get('n_waterfalls')} waterfalls)", flush=True)
            try:
                assert_slos(rep, cfg)
                rs = rep.reshard or {}
                print(f"  OK  p99_outside={rep.p99_outside_ms:.3f}ms "
                      f"(budget {cfg.resolved_budget_ms()}ms, "
                      f"n={rep.n_outside}) parity={rep.parity_checked} "
                      f"failovers={rep.engine_stats.get('failovers')} "
                      f"swap_backs={rep.engine_stats.get('swap_backs')} "
                      f"child_restarts={rep.child_restarts}"
                      + (f" reshards={rs.get('executed')} "
                         f"(blackout_max={rs.get('blackout_ms_max')}ms, "
                         f"epoch={rs.get('epoch')})"
                         if rep.reshard is not None else "")
                      + (f" incidents={len(rep.incidents)} (all explained)"
                         if rep.incidents is not None else ""), flush=True)
            except AssertionError as e:
                failures += 1
                print(f"  SLO FAILED: {e}", file=sys.stderr, flush=True)
    # aggregate across ALL campaigns: each run resets the telemetry hub,
    # so the live chaos_status_lines() view only covers the last one —
    # the run log must report the whole invocation's injected inventory
    totals: Dict[str, int] = {}
    for rep_d in reports:
        for kind, n in (rep_d.get("chaos_counts") or {}).items():
            totals[kind] = totals.get(kind, 0) + n
    print(f"nemesis event counts across {len(reports)} campaign(s):")
    for kind in sorted(totals):
        print(f"  {kind:<18} {totals[kind]}")
    out = {"campaigns": reports}
    if args.sweep:
        print("served_under_chaos sweep ...", flush=True)
        sweep = run_served_under_chaos(budget_ms=args.budget_ms)
        out["served_under_chaos"] = sweep
        print(json.dumps(sweep["users_served_per_chip"]))
        for row in sweep["sweep"]:
            print(f"  s={row['s']:<4} admission={str(row['admission']):<5} "
                  f"p99={row['p99_ms']:>9.3f}ms in_budget={row['in_budget']} "
                  f"throttled={row['throttled_frac']:.0%} "
                  f"aborts={row['abort_frac']:.0%}", flush=True)
        ok_ctrl = all(r["in_budget"] for r in sweep["sweep"] if r["admission"])
        bad_unctrl = all(not r["in_budget"]
                         for r in sweep["sweep"] if not r["admission"])
        if not (ok_ctrl and bad_unctrl):
            failures += 1
            print("SWEEP FAILED: admission must hold p99 in budget while "
                  "uncontrolled runs exceed it", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=str)
        print(f"reports -> {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
