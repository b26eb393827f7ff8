"""Unified telemetry registry: one bridge from the serving path's disjoint
counter islands into the TDMetric time-series machinery.

Port of ``foundationdb_tpu/core/telemetry.py``: the same TelemetryHub,
with every register_* call, sync(), snapshot() and prometheus_text(). The
sources the port has (EnginePerf, PerfLedger, the heat aggregator, tiered
history, the loop engine, the BudgetBatcher, the ConflictScheduler)
register from their constructors; the registrations for sources not
ported yet (health, mesh, admission, reshard, blackbox, recovery) take
any object with the attributes sync() reads.

  * `snapshot()` is the live status fragment;
  * `prometheus_text()` renders the current values as a Prometheus-style
    text exposition.

The cluster watchdog (core/watchdog.py) is not ported yet: the hub starts
with none attached, and the `watchdog_enabled` knob raises at hub
construction rather than running without it. Registration is
append-only and draws no rng.
"""
from __future__ import annotations

import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from .tdmetric import TDMetricCollection
from .trace import span_now

#: health states in transition-metric encoding (fault/resilient.py's
#: state machine; the Int64 series records the index at each transition)
HEALTH_STATE_INDEX = {"healthy": 0, "suspect": 1, "failed": 2,
                      "probation": 3, "quarantined": 4}


def _engine_state_bytes(engine) -> Optional[int]:
    """Footprint of an engine's resolved-history state, in bytes — the
    device interval table for kernel engines (a dict of arrays), reached
    through a ResilientEngine's wrapped device when supervised. None when
    the engine keeps no array state (the serial oracle).
    server/resolver.py uses the same helper for its engine_health
    fragment."""
    dev = getattr(engine, "device", engine)
    st = getattr(dev, "state", None)
    if not isinstance(st, dict):
        return None
    try:
        return int(sum(int(getattr(v, "nbytes", 0)) for v in st.values()))
    except (TypeError, ValueError):
        return None


class TelemetryHub:
    """Per-process registry of serving-path telemetry sources.

    Registries hold WEAK references: engines/batchers register at
    construction with no unregister path, and a long-lived wall-clock
    process (real demo server, bench drivers, repeated pipeline
    construction) must not pin every discarded engine — and its device
    state — forever, nor pay sync() cost scaling with process lifetime.
    A collected source simply stops updating; its last synced values
    remain in the TDMetric series. (In simulation the cluster and the
    fault registry keep live sources strongly reachable anyway.)"""

    def __init__(self) -> None:
        self.tdmetrics = TDMetricCollection(now=span_now)
        #: label -> weakref to EnginePerf
        self._engine_perf: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to BudgetBatcher
        self._batchers: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to ResilientEngine
        self._health: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to DeviceLoopEngine (queue/ring gauges —
        #: ops/device_loop.py loop_stats + occupancy)
        self._loops: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to MeshShardedConflictEngine (device-mesh
        #: gauges — parallel/mesh_engine.py mesh_stats + ring drain
        #: accounting)
        self._meshes: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to KeyRangeHeatAggregator (core/heatmap.py —
        #: keyspace heat, occupancy headroom, split planning)
        self._heat: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to PerfLedger (core/perfledger.py — compile &
        #: memory ledger: build durations, flops/bytes, peak HBM)
        self._perf_ledgers: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to TenantAdmission (server/ratekeeper.py —
        #: admitted/rejected totals feed the throttle burn-rate rule)
        self._admissions: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to ReshardController (server/reshard.py —
        #: executed/stalled/blackout gauges feed the `fdbtpu_reshard`
        #: family and the watchdog's reshard rules)
        self._reshards: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to ConflictScheduler (pipeline/scheduler.py —
        #: decision counters, probe/mispredict pair and lane gauges feed
        #: the `fdbtpu_sched` family and the sched_mispredict rule)
        self._scheds: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to BlackBoxJournal (core/blackbox.py —
        #: durable-write accounting: events, fsync cadence cost, shed
        #: events and the durability-gap flag)
        self._blackboxes: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to RecoveryTracker (fault/recovery.py —
        #: in-flight recovery age feeds the `recovery_stalled` rule,
        #: completed arcs feed the blackout gauges)
        self._recoveries: Dict[str, "weakref.ref"] = {}
        #: label -> weakref to a tiered-history engine (ops/host_engine.py
        #: — run/merge accounting mirrored from the heat aggregate's
        #: `runs` leaf, synced as `history.<label>.*` / fdbtpu_history)
        self._histories: Dict[str, "weakref.ref"] = {}
        self._seq = 0
        #: bounded ring of recent nemesis/chaos events (real/chaos.py,
        #: real/nemesis.py) — rendered by `tools/cli.py chaos-status`
        self.chaos_events: deque = deque(maxlen=256)
        #: the cluster watchdog (core/watchdog.py): None (default) = the
        #: disabled path — sync() pays ONE attribute check and allocates
        #: nothing. The watchdog is not ported yet, so the
        #: `watchdog_enabled` knob raises here instead of leaving it off;
        #: attach_watchdog() takes any object with evaluate(hub) and
        #: snapshot().
        from .knobs import SERVER_KNOBS

        if SERVER_KNOBS.watchdog_enabled:
            raise NotImplementedError(
                "the watchdog_enabled knob is set, but the cluster watchdog "
                "(core/watchdog.py) is not ported to foundationdb_tpu_torch yet")
        self._watchdog = None

    # -- registration --------------------------------------------------------
    def _label(self, kind: str, name: str) -> str:
        self._seq += 1
        return f"{name or kind}.{self._seq}"

    def register_engine_perf(self, perf, name: str = "engine") -> str:
        label = self._label("engine", name)
        self._engine_perf[label] = weakref.ref(perf)
        return label

    def register_batcher(self, batcher, name: str = "batcher") -> str:
        label = self._label("batcher", name)
        self._batchers[label] = weakref.ref(batcher)
        return label

    def register_health(self, engine, name: str = "resilient") -> str:
        label = self._label("resilient", name)
        self._health[label] = weakref.ref(engine)
        return label

    def register_loop(self, engine, name: str = "loop") -> str:
        """A device-resident loop engine's queue/ring gauges
        (ops/device_loop.py): slot occupancy, result-ring depth and the
        sync-accounting counters, synced as `loop.<label>.*` series."""
        label = self._label("loop", name)
        self._loops[label] = weakref.ref(engine)
        return label

    def register_mesh(self, engine, name: str = "mesh") -> str:
        """A multi-device mesh engine's topology + exchange gauges
        (parallel/mesh_engine.py): device count, per-shard table bytes,
        the measured cross-shard exchange interval and the same
        non-blocking drain accounting as the device loop, synced as
        `mesh.<label>.*` series (the `fdbtpu_mesh` exposition family)."""
        label = self._label("mesh", name)
        self._meshes[label] = weakref.ref(engine)
        return label

    def register_perf_ledger(self, ledger, name: str = "perf") -> str:
        """An engine's compile & memory ledger (core/perfledger.py):
        warmup/steady compile counts and durations, cost-analysis
        flops/bytes and peak compiled-program HBM, synced as
        `perf.<label>.*` series (the `fdbtpu_perf` Prometheus family)."""
        label = self._label("perf", name)
        self._perf_ledgers[label] = weakref.ref(ledger)
        return label

    def register_admission(self, admission, name: str = "admission") -> str:
        """A per-tenant admission controller (server/ratekeeper.py
        TenantAdmission): admitted/rejected totals synced as
        `admission.<label>.*` series — the good/bad pair the watchdog's
        tenant_throttle_burn rule consumes."""
        label = self._label("admission", name)
        self._admissions[label] = weakref.ref(admission)
        return label

    def register_reshard(self, controller, name: str = "reshard") -> str:
        """An online-resharding controller (server/reshard.py): executed
        and stalled counts, in-flight age and blackout accounting synced
        as `reshard.<label>.*` series — the `fdbtpu_reshard` exposition
        family, and the series the watchdog's ReshardStalledRule and
        blackout-overrun rule evaluate."""
        label = self._label("reshard", name)
        self._reshards[label] = weakref.ref(controller)
        return label

    def register_scheduler(self, scheduler, name: str = "sched") -> str:
        """A conflict scheduler (pipeline/scheduler.py ConflictScheduler):
        per-decision counters (dispatched/deferred/laned/pre-aborted),
        the probe vs mispredict pair the watchdog's sched_mispredict
        burn rule consumes, and lane/predictor gauges, synced as
        `sched.<label>.*` series — the `fdbtpu_sched` family."""
        label = self._label("sched", name)
        self._scheds[label] = weakref.ref(scheduler)
        return label

    def register_blackbox(self, journal, name: str = "blackbox") -> str:
        """A durable black-box journal (core/blackbox.py): event/fsync
        counts, fsync wall cost and the shed-to-memory accounting
        (`shed_events` / `durability_gap`), synced as
        `blackbox.<label>.*` series — the crash-window contract's eyes
        (docs/observability.md)."""
        label = self._label("blackbox", name)
        self._blackboxes[label] = weakref.ref(journal)
        return label

    def register_recovery(self, tracker, name: str = "recovery") -> str:
        """A crash-stop recovery tracker (fault/recovery.py
        RecoveryTracker): recovery counts, worst blackout and the
        in-flight age the watchdog's `recovery_stalled` rule evaluates,
        synced as `recovery.<label>.*` series."""
        label = self._label("recovery", name)
        self._recoveries[label] = weakref.ref(tracker)
        return label

    def recovery_source(self, label: str):
        """The live RecoveryTracker registered under `label` (None if
        collected) — the stalled-recovery rule reads its in-flight
        detail through this to compose a speakable incident line."""
        ref = self._recoveries.get(label)
        return ref() if ref is not None else None

    def reshard_source(self, label: str):
        """The live controller registered under `label` (None if
        collected) — the stalled-reshard rule reads its range/donor
        detail through this to compose a speakable incident line."""
        ref = self._reshards.get(label)
        return ref() if ref is not None else None

    # -- the cluster watchdog (core/watchdog.py) -----------------------------
    @property
    def watchdog(self):
        return self._watchdog

    def attach_watchdog(self, wd) -> None:
        """Install (or replace) the process watchdog; None detaches. The
        attached engine evaluates on every sync()."""
        self._watchdog = wd

    def register_heat(self, aggregator, name: str = "heat") -> str:
        """An engine's keyspace-heat aggregator (core/heatmap.py): hot-range
        concentration, occupancy headroom, GC pressure and verdict totals,
        synced as `heat.<label>.*` series."""
        label = self._label("heat", name)
        self._heat[label] = weakref.ref(aggregator)
        return label

    def register_history(self, engine, name: str = "history") -> str:
        """An engine running the TIERED history structure
        (ops/host_engine.py): structure identity plus the run
        append/merge counters its heat aggregator derives from the
        device heat aggregate's run-depth leaf, synced as
        `history.<label>.*` series — the `fdbtpu_history` family.
        Monolithic engines never register (the exposition stays
        byte-stable for the fleet that hasn't flipped the knob)."""
        label = self._label("history", name)
        self._histories[label] = weakref.ref(engine)
        return label

    @staticmethod
    def _live(registry: Dict[str, "weakref.ref"]):
        """(label, source) for live sources; dead entries are pruned."""
        dead = [label for label, ref in registry.items() if ref() is None]
        for label in dead:
            del registry[label]
        return [(label, ref()) for label, ref in registry.items()
                if ref() is not None]

    def record_health_transition(self, label: str, state: str) -> None:
        """Called by ResilientEngine._set_state on every transition: the
        change history IS the incident timeline (TDMetric read model).
        Recorded unconditionally — the construction-time entry indexes 0
        (healthy), which a level metric's change-only set() would swallow,
        and an engine's very existence belongs in the timeline."""
        m = self.tdmetrics.int64(f"resolver.{label}.state")
        m.value = HEALTH_STATE_INDEX.get(state, -1)
        m._record(m.value)

    def chaos_event(self, kind: str, **detail: Any) -> None:
        """Record one injected fault / nemesis action: an Int64 counter per
        kind (`chaos.<kind>` — rides every hub frontend: Prometheus text,
        metric logger, status snapshots) plus a bounded event ring with the
        details, so `tools/cli.py chaos-status` can show WHAT the nemesis
        did, not just how often."""
        m = self.tdmetrics.int64(f"chaos.{kind}")
        m.increment()
        self.chaos_events.append({"kind": kind, "t": span_now(), **detail})

    def chaos_counts(self) -> Dict[str, int]:
        """kind -> count for every chaos.* counter this process recorded."""
        out: Dict[str, int] = {}
        for name, m in self.tdmetrics.metrics.items():
            if name.startswith("chaos."):
                out[name[len("chaos."):]] = int(getattr(m, "value", 0))
        return out

    # -- bridging ------------------------------------------------------------
    def sync(self) -> None:
        """Pull every registered source's current values into the TDMetric
        collection (level metrics record only on change, so a quiet sync is
        free). Run before each MetricLogger drain or status snapshot."""
        from . import buggify

        if buggify.buggify():
            # stale telemetry: one sync silently skipped — the change-history
            # metric model must tolerate a lagging bridge (values catch up on
            # the next sync; level metrics record no spurious entries)
            return
        td = self.tdmetrics
        for label, perf in self._live(self._engine_perf):
            td.int64(f"engine.{label}.compiles").set(perf.compiles)
            for bucket, hits in perf.bucket_hits.items():
                td.int64(f"engine.{label}.bucket_hits.{bucket}").set(hits)
            for scan, n in perf.scan_dispatches.items():
                td.int64(f"engine.{label}.scan_dispatches.{scan}").set(n)
            # history-search mode picks (docs/perf.md): chunks dispatched
            # per mode, so `tools/cli.py telemetry` and the Prometheus
            # exposition surface `search_mode_hits_*` with no extra wiring
            for mode, n in getattr(perf, "search_mode_hits", {}).items():
                td.int64(f"engine.{label}.search_mode_hits.{mode}").set(n)
            # dispatch mode (docs/perf.md "Device-resident loop"): step vs
            # loop chunk counts, same frontends as the search-mode picks
            for mode, n in getattr(perf, "dispatch_mode_hits", {}).items():
                td.int64(f"engine.{label}.dispatch_mode_hits.{mode}").set(n)
            # abort-cause split (docs/observability.md "Keyspace heat &
            # occupancy"): committed vs conflicts vs too_old, aggregated —
            # previously only visible per batch in status_of
            for kind, n in getattr(perf, "verdicts", {}).items():
                td.int64(f"engine.{label}.verdicts.{kind}").set(n)
            # sampled measured device timing (docs/observability.md
            # "Performance observatory"): mean per-chunk enqueue->ready
            # microseconds and sample counts per bucket
            if getattr(perf, "device_time", None):
                for b, ms in perf.device_time_ms_by_bucket().items():
                    td.int64(f"engine.{label}.device_time_us.{b}").set(
                        int(ms * 1000))
                for b, d in perf.device_time.items():
                    td.int64(f"engine.{label}.device_time_samples.{b}").set(
                        int(d["samples"]))
        for label, b in self._live(self._batchers):
            # EWMAs are floats; the Int64 series stores microseconds so the
            # persisted change history stays integral. Keys are per
            # (bucket, history-search mode, dispatch mode) — search modes
            # have different device-time floors for the same shape, and
            # the device loop removes per-batch dispatch cost the step
            # path pays (docs/perf.md)
            for (bucket, mode, dispatch), ms in b.ewma_ms.items():
                td.int64(
                    f"batcher.{label}.ewma_us.{bucket}.{mode}.{dispatch}"
                ).set(int(ms * 1000))
        for label, eng in self._live(self._health):
            st = eng.stats
            for key in ("batches", "dispatch_faults", "retries", "failovers",
                        "swap_backs", "probes", "probe_mismatches",
                        "oracle_batches"):
                td.int64(f"resolver.{label}.{key}").set(st.get(key, 0))
            # state-memory accounting (reference: RESOLVER_STATE_MEMORY_
            # LIMIT): the supervised device table's footprint vs the knob,
            # as a series so the watchdog's state_memory_pressure rule
            # evaluates it live (server/resolver.py mirrors the same
            # figures into engine_health for the status doc)
            sb = _engine_state_bytes(eng)
            if sb is not None:
                from .knobs import SERVER_KNOBS

                td.int64(f"resolver.{label}.state_bytes").set(sb)
                td.int64(f"resolver.{label}.state_memory_pressure").set(
                    1 if sb > int(SERVER_KNOBS.resolver_state_memory_limit)
                    else 0)
        for label, rc in self._live(self._reshards):
            # online-resharding gauges (server/reshard.py): epoch + shard
            # count for the live map, executed/stalled op counts, the
            # worst observed blackout vs budget, and the in-flight age
            # the ReshardStalledRule evaluates
            td.int64(f"reshard.{label}.epoch").set(rc.group.emap.epoch)
            td.int64(f"reshard.{label}.shards").set(
                len(rc.group.active_sids()))
            td.int64(f"reshard.{label}.executed").set(rc.executed)
            td.int64(f"reshard.{label}.stalled").set(rc.stalled)
            td.int64(f"reshard.{label}.in_flight").set(
                1 if rc.in_flight() else 0)
            td.int64(f"reshard.{label}.in_flight_age_us").set(
                int(rc.in_flight_age_s() * 1e6))
            td.int64(f"reshard.{label}.blackout_us_max").set(
                int(rc.blackout_ms_max * 1000))
            td.int64(f"reshard.{label}.blackout_over_budget").set(
                rc.blackout_over_budget)
        for label, adm in self._live(self._admissions):
            # per-tenant admission totals (server/ratekeeper.py): the
            # offered split into admitted vs shed — the watchdog's
            # tenant_throttle_burn good/bad pair
            td.int64(f"admission.{label}.admitted").set(
                sum(adm.admitted.values()))
            td.int64(f"admission.{label}.rejected").set(
                sum(adm.rejected.values()))
        for label, sch in self._live(self._scheds):
            # conflict-scheduler eyes (pipeline/scheduler.py): every
            # decision counter, the probe_ok/mispredicts pair the
            # watchdog's sched_mispredict rule burns against, live lane
            # depth and the predictor's tracked-range count
            for key, n in sch.counters.items():
                td.int64(f"sched.{label}.{key}").set(int(n))
            td.int64(f"sched.{label}.lanes").set(len(sch.lanes))
            td.int64(f"sched.{label}.pending_laned").set(
                sch.pending_laned())
            td.int64(f"sched.{label}.tracked_ranges").set(
                len(sch.predictor.scores))
            td.int64(f"sched.{label}.mispredict_frac_x1000").set(
                int(sch.mispredict_frac() * 1000))
        for label, eng in self._live(self._loops):
            # device-loop eyes (ops/device_loop.py): the double buffer's
            # slot occupancy, the result ring's depth, and every
            # sync-accounting counter — blocking_syncs must read 0 on any
            # healthy scrape
            st = eng.loop_stats
            for key in ("enqueued_chunks", "units", "drained_nonblocking",
                        "forced_waits", "blocking_syncs"):
                td.int64(f"loop.{label}.{key}").set(int(st.get(key, 0)))
            td.int64(f"loop.{label}.wait_us").set(
                int(st.get("wait_ms", 0.0) * 1000))
            td.int64(f"loop.{label}.ring_depth").set(eng.ring_depth())
            td.int64(f"loop.{label}.slots_in_flight").set(
                eng.slots_in_flight())
        for label, eng in self._live(self._meshes):
            # mesh eyes (parallel/mesh_engine.py): the device topology,
            # per-shard table residency, the measured exchange interval
            # and the same sync accounting as the loop family —
            # blocking_syncs must read 0 on any healthy scrape
            st = eng.loop_stats
            for key in ("enqueued_chunks", "units", "drained_nonblocking",
                        "forced_waits", "blocking_syncs"):
                td.int64(f"mesh.{label}.{key}").set(int(st.get(key, 0)))
            td.int64(f"mesh.{label}.wait_us").set(
                int(st.get("wait_ms", 0.0) * 1000))
            td.int64(f"mesh.{label}.ring_depth").set(eng.ring_depth())
            ms = eng.mesh_stats
            td.int64(f"mesh.{label}.n_devices").set(int(ms["n_devices"]))
            td.int64(f"mesh.{label}.exchanges").set(int(ms["exchanges"]))
            td.int64(f"mesh.{label}.table_bytes_per_shard").set(
                int(ms["table_bytes_per_shard"]))
            td.int64(f"mesh.{label}.last_collective_us").set(
                int(ms.get("last_collective_ms", 0.0) * 1000))
        for label, led in self._live(self._perf_ledgers):
            # compile & memory ledger (core/perfledger.py): warmup/steady
            # compile counts + total build time, the cost-analysis
            # totals, and the largest single-program HBM pin — the
            # `fdbtpu_perf` exposition family
            for kind in ("warmup", "steady"):
                td.int64(f"perf.{label}.compiles_{kind}").set(
                    led.compiles.get(kind, 0))
                td.int64(f"perf.{label}.compile_us_{kind}").set(
                    int(led.compile_ms.get(kind, 0.0) * 1000))
            td.int64(f"perf.{label}.peak_hbm_bytes").set(led.peak_bytes)
            td.int64(f"perf.{label}.flops_total").set(led.flops_total)
            td.int64(f"perf.{label}.bytes_accessed_total").set(
                led.bytes_accessed_total)
        for label, agg in self._live(self._heat):
            # keyspace heat & occupancy (core/heatmap.py): contention
            # concentration, table headroom and GC pressure as integer
            # gauges (x1000 fixed-point for the [0,1] fractions). brief()
            # is the single-pass read (one argmax, one key formatted) —
            # hot_ranges would sort and format every retained range per
            # sync tick
            b = agg.brief()
            td.int64(f"heat.{label}.batches").set(agg.batches)
            td.int64(f"heat.{label}.occupancy").set(agg.occupancy)
            td.int64(f"heat.{label}.occupancy_frac_x1000").set(
                int(b["occupancy_frac"] * 1000))
            td.int64(f"heat.{label}.gc_reclaimed").set(
                agg.gc_reclaimed_total)
            td.int64(f"heat.{label}.concentration_x1000").set(
                int(b["concentration"] * 1000))
            td.int64(f"heat.{label}.top_range_share_x1000").set(
                int(b["top_share"] * 1000))
        for label, bb in self._live(self._blackboxes):
            # durable-journal eyes (core/blackbox.py): event/segment
            # counts, the knobbed fsync cadence's wall cost, and the
            # shed-to-memory accounting — `durability_gap` reading 1
            # means the on-disk suffix is honest-but-incomplete
            td.int64(f"blackbox.{label}.events").set(
                int(bb.events_written))
            td.int64(f"blackbox.{label}.fsyncs").set(int(bb.fsyncs))
            td.int64(f"blackbox.{label}.fsync_us").set(
                int(bb.fsync_ms * 1000))
            td.int64(f"blackbox.{label}.dropped_errors").set(
                int(bb.dropped_errors))
            td.int64(f"blackbox.{label}.shed_events").set(
                int(bb.shed_events))
            td.int64(f"blackbox.{label}.durability_gap").set(
                1 if bb.durability_gap else 0)
        for label, eng in self._live(self._histories):
            # tiered-history eyes (ops/host_engine.py
            # history_stats_snapshot): run-stack depth, append/merge
            # counters and live tier occupancy — all mirrored from the
            # per-batch heat aggregate, zero extra device syncs
            h = eng.history_stats_snapshot()
            td.int64(f"history.{label}.tiered").set(
                1 if h.get("structure") == "tiered" else 0)
            td.int64(f"history.{label}.run_slots").set(
                int(h.get("run_slots", 0)))
            td.int64(f"history.{label}.run_rows").set(
                int(h.get("run_rows", 0)))
            td.int64(f"history.{label}.appends").set(
                int(h.get("appends", 0)))
            td.int64(f"history.{label}.merges").set(
                int(h.get("merges", 0)))
            td.int64(f"history.{label}.runs_live").set(
                int(h.get("runs_live", 0)))
            td.int64(f"history.{label}.run_rows_live").set(
                int(h.get("run_rows_live", 0)))
        for label, rt in self._live(self._recoveries):
            # crash-stop recovery eyes (fault/recovery.py): completed
            # and failed recoveries, the worst observed blackout, and
            # the in-flight age the RecoveryStalledRule evaluates
            td.int64(f"recovery.{label}.recoveries").set(
                int(rt.recoveries))
            td.int64(f"recovery.{label}.failures").set(int(rt.failures))
            td.int64(f"recovery.{label}.in_flight").set(
                1 if rt.in_flight() else 0)
            td.int64(f"recovery.{label}.in_flight_age_us").set(
                int(rt.in_flight_age_s() * 1e6))
            td.int64(f"recovery.{label}.blackout_us_max").set(
                int(rt.blackout_ms_max * 1000))
        # cluster watchdog (core/watchdog.py): evaluate the rule set over
        # the series refreshed above. The disabled path is this one
        # attribute check — no call, no allocation (the <5 µs/call
        # regression guard in tests/test_watchdog.py)
        wd = self._watchdog
        if wd is not None:
            wd.evaluate(self)

    def snapshot(self) -> dict:
        """Live values for status documents (no TDMetric round trip)."""
        return {
            "engines": {label: perf.as_dict()
                        for label, perf in self._live(self._engine_perf)},
            "batchers": {label: b.as_dict()
                         for label, b in self._live(self._batchers)},
            "health": {label: eng.health_stats()
                       for label, eng in self._live(self._health)},
            "loops": {label: eng.loop_stats_snapshot()
                      for label, eng in self._live(self._loops)},
            "meshes": {label: eng.mesh_stats_snapshot()
                       for label, eng in self._live(self._meshes)},
            "heat": {label: agg.snapshot()
                     for label, agg in self._live(self._heat)},
            "history": {label: eng.history_stats_snapshot()
                        for label, eng in self._live(self._histories)},
            "perf_ledgers": {label: led.snapshot()
                             for label, led in self._live(self._perf_ledgers)},
            "admission": {label: adm.as_dict()
                          for label, adm in self._live(self._admissions)},
            "reshard": {label: rc.snapshot()
                        for label, rc in self._live(self._reshards)},
            "sched": {label: sch.snapshot()
                      for label, sch in self._live(self._scheds)},
            "blackbox": {label: bb.summary()
                         for label, bb in self._live(self._blackboxes)},
            "recovery": {label: {"recoveries": rt.recoveries,
                                 "failures": rt.failures,
                                 "in_flight": rt.in_flight(),
                                 "blackout_ms_max":
                                     round(rt.blackout_ms_max, 3),
                                 "last": rt.last}
                         for label, rt in self._live(self._recoveries)},
            "watchdog": (self._watchdog.snapshot()
                         if self._watchdog is not None else None),
        }

    #: per-family HELP strings for the exposition (families are the first
    #: dotted component of a series name; anything else gets the generic)
    _PROM_HELP = {
        "engine": "conflict-engine perf counters (compiles, bucket/scan/"
                  "search/dispatch-mode hits); series label = the dotted "
                  "series name under engine.",
        "batcher": "budget-batcher latency EWMAs in microseconds, keyed "
                   "(bucket, search mode, dispatch mode)",
        "resolver": "supervised-resolver health counters and state index "
                    "(fault/resilient.py)",
        "loop": "device-resident loop queue/ring gauges "
                "(ops/device_loop.py; blocking_syncs must be 0)",
        "mesh": "multi-device mesh engine gauges (parallel/mesh_engine"
                ".py: device topology, per-shard table bytes, measured "
                "exchange interval; blocking_syncs must be 0)",
        "heat": "keyspace heat & history-occupancy gauges "
                "(core/heatmap.py; fractions are x1000 fixed-point)",
        "history": "tiered-history structure gauges (ops/conflict_kernel"
                   ".py tiered sorted runs: run-stack depth, append/merge "
                   "counters, live tier rows — mirrored from the heat "
                   "aggregate with zero extra syncs)",
        "perf": "compile & memory ledger gauges (core/perfledger.py: "
                "warmup/steady compile counts and microseconds, "
                "cost-analysis totals, peak compiled-program HBM bytes)",
        "chaos": "injected nemesis fault events (real/chaos.py)",
        "demo": "demo KV per-op counters (real/demo_server.py)",
        "alerts": "cluster-watchdog alert states (core/watchdog.py: 0 ok, "
                  "1 pending, 2 firing; `alerts.firing` counts the live "
                  "firing set — the ALERTS-style family)",
        "sli": "commit SLO indicator counters (core/watchdog.py "
               "record_commit_sli: acks within/over the latency budget)",
        "admission": "per-tenant admission totals (server/ratekeeper.py "
                     "TenantAdmission: admitted vs shed)",
        "reshard": "online-resharding controller gauges "
                   "(server/reshard.py: live epoch/shard count, executed/"
                   "stalled ops, in-flight age, blackout vs budget)",
        "sched": "conflict-scheduler gauges (pipeline/scheduler.py: "
                 "decision counters, probe vs mispredict pair, lane "
                 "depth, tracked predictor ranges; fractions are x1000 "
                 "fixed-point)",
        "blackbox": "durable black-box journal gauges (core/blackbox.py: "
                    "event/segment/fsync counts, fsync microseconds, "
                    "shed-to-memory events; durability_gap=1 means the "
                    "on-disk suffix is honest-but-incomplete)",
        "recovery": "crash-stop recovery gauges (fault/recovery.py: "
                    "recovery/failure counts, in-flight age, worst "
                    "blackout microseconds — the recovery_stalled "
                    "rule's series)",
        "scenario": "scenario-atlas scorecard gauges (real/scenarios.py "
                    "publish_scenario: per-scenario p99 microseconds, "
                    "abort/throttle fractions and heat concentration as "
                    "x1000 fixed-point, slo_pass 0/1)",
    }

    @staticmethod
    def _prom_name(s: str) -> str:
        """Sanitize to the metric-name charset [a-zA-Z0-9_:]."""
        out = "".join(c if (c.isascii() and (c.isalnum() or c == "_"))
                      else "_" for c in s)
        return out if out and not out[0].isdigit() else "_" + out

    @staticmethod
    def _prom_escape(s: str) -> str:
        """Label-value escaping per the exposition format: backslash,
        double quote and newline must be escaped or a scraper rejects
        (or silently mis-parses) the whole exposition."""
        return (s.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def prometheus_text(self) -> str:
        """Current value of every registered series as a Prometheus text
        exposition a REAL scraper parses cleanly: one metric family per
        first dotted component (`fdbtpu_engine`, `fdbtpu_chaos`, ...),
        each preceded by its `# HELP`/`# TYPE` lines, with the full
        dotted series name carried in the `series` label — label VALUES
        may contain dots, slashes, quotes or anything else an engine
        label picked up, so they are escaped, not sanitized away."""
        self.sync()
        groups: Dict[str, List[tuple]] = {}
        for name in sorted(self.tdmetrics.metrics):
            m = self.tdmetrics.metrics[name]
            value = getattr(m, "value", None)
            if value is None:   # ContinuousMetric: expose the event count
                value = len(m.buffer)
            family, _, rest = name.partition(".")
            groups.setdefault(family, []).append((rest, value))
        lines: List[str] = []
        for family in sorted(groups):
            fam = "fdbtpu_" + self._prom_name(family)
            help_text = self._PROM_HELP.get(
                family, f"fdb-tpu telemetry series under '{family}.'")
            lines.append(f"# HELP {fam} {help_text}")
            lines.append(f"# TYPE {fam} gauge")
            for rest, value in groups[family]:
                if rest:
                    lines.append(
                        f'{fam}{{series="{self._prom_escape(rest)}"}} {value}')
                else:
                    lines.append(f"{fam} {value}")
        return "\n".join(lines) + "\n"


_hub = TelemetryHub()


def hub() -> TelemetryHub:
    return _hub


def reset() -> None:
    """Fresh hub (Simulator.__init__, like fault.reset_registry)."""
    global _hub
    _hub = TelemetryHub()
