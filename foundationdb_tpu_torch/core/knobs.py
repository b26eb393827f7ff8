"""Typed, name-addressed tunables.

Port of ``foundationdb_tpu/core/knobs.py``: the same three registries with
every name, default and randomizer, so a knob set by name means the same
in both packages.

Analog of the reference's three knob registries (flow/Knobs.h:31-45,
fdbserver/Knobs.cpp). Knobs default in one place, can be overridden by name
(`--knob_name=value` style), and in simulation BUGGIFY may randomize marked
knobs so rare configurations get exercised.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .rng import DeterministicRandom


class Knobs:
    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}
        self._randomizers: Dict[str, Callable[[DeterministicRandom], Any]] = {}

    def init(self, name: str, value: Any, buggify: Optional[Callable[[DeterministicRandom], Any]] = None):
        self._values[name] = value
        if buggify is not None:
            self._randomizers[name] = buggify
        return value

    def set_knob(self, name: str, value: str) -> None:
        if name not in self._values:
            raise KeyError(f"unknown knob: {name}")
        cur = self._values[name]
        if isinstance(cur, bool):
            self._values[name] = value.lower() in ("1", "true", "on")
        elif isinstance(cur, int):
            self._values[name] = int(value)
        elif isinstance(cur, float):
            self._values[name] = float(value)
        else:
            self._values[name] = value

    def randomize(self, rng: DeterministicRandom, probability: float = 0.25) -> None:
        """BUGGIFY-style knob randomization, applied per-simulation
        (reference pattern: `init(KNOB, v); if(randomize && BUGGIFY) ...`,
        fdbserver/Knobs.cpp)."""
        for name, fn in self._randomizers.items():
            if rng.random01() < probability:
                self._values[name] = fn(rng)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_values"][name.lower()]
        except KeyError:
            raise AttributeError(name)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


def _make_server_knobs() -> Knobs:
    k = Knobs()
    # Version / MVCC window (reference: fdbserver/Knobs.cpp)
    k.init("versions_per_second", 1_000_000)
    k.init("max_write_transaction_life_versions", 5_000_000)
    k.init("max_read_transaction_life_versions", 5_000_000)
    # Proxy commit batching (reference: COMMIT_TRANSACTION_BATCH_* knobs)
    k.init("commit_transaction_batch_interval", 0.0005, lambda r: r.random01() * 0.005)
    k.init("commit_transaction_batch_count_max", 32768, lambda r: r.random_int(1, 100))
    k.init("commit_transaction_batch_bytes_max", 8 << 20)
    #: bound on a resolver's conflict-history state footprint (reference:
    #: RESOLVER_STATE_MEMORY_LIMIT). Ours is the device interval table —
    #: capacity H x K key words plus versions is a few MB at the default
    #: shape — so the bound is sized with headroom above that; the
    #: resolver reports `state_bytes` and a `state_memory_pressure` flag
    #: in engine_health (server/resolver.py) when the footprint exceeds it
    k.init("resolver_state_memory_limit", 64 << 20)
    k.init("grv_batch_interval", 0.0005, lambda r: r.random01() * 0.005)
    # Ratekeeper (reference: fdbserver/Knobs.cpp ratekeeper section)
    k.init("ratekeeper_update_interval", 0.25)
    k.init("target_storage_queue_bytes", 4 << 20)
    k.init("spring_storage_queue_bytes", 2 << 20)
    k.init("target_tlog_queue_bytes", 1 << 30)
    # TLog spill (reference: updatePersistentData, TLogServer.actor.cpp:539)
    k.init("tlog_spill_bytes", 2 << 20, lambda r: r.random_int(2_000, 200_000))
    #: simulated fsync for diskless tlog roles (the static sim cluster);
    #: the default models a conservative SSD — benchmark profiles
    #: (pipeline/latency_harness.py) set a datacenter-NVMe figure
    k.init("tlog_fsync_seconds", 0.0005)
    k.init("max_transactions_per_second", 1e7)
    # Storage
    k.init("storage_durability_lag_versions", 2_000_000)
    k.init("desired_total_bytes", 150_000)
    #: byte-sample granularity (reference: BYTE_SAMPLING_FACTOR — keys are
    #: sampled with probability size/factor and carry weight `factor`)
    k.init("dd_byte_sample_factor", 200)
    # DataDistribution (reference: DataDistributionTracker split/merge +
    # DataDistributionQueue priorities/parallelism)
    k.init("dd_tracker_interval", 2.0)
    k.init("dd_shard_split_bytes", 100_000, lambda r: r.random_int(4_000, 50_000))
    k.init("dd_shard_merge_bytes", 2_000)
    #: write-bandwidth split trigger (bytes/sec of applied mutations; the
    #: reference splits on SHARD_MAX_BYTES_PER_KSEC); a hot-WRITE shard
    #: splits even while its size is under dd_shard_split_bytes
    k.init("dd_shard_split_bandwidth", 200_000)
    #: concurrent relocations the DD queue may run (reference:
    #: DD_MOVE_KEYS_PARALLELISM)
    k.init("dd_move_parallelism", 2)
    # Failure detection (reference: CC failureDetectionServer)
    k.init("failure_detection_delay", 1.0, lambda r: 0.2 + r.random01() * 2)
    k.init("heartbeat_interval", 0.25)
    # Device-fault tolerance (fault/resilient.py; docs/fault_tolerance.md).
    # Deliberately no BUGGIFY randomizers: the nemesis campaign stresses
    # these directly, and randomizer draws would shift every sim's rng
    # stream for knobs that only matter when a device is sick.
    #: watchdog: a dispatch outstanding longer than this is a fault
    k.init("resolver_dispatch_timeout", 0.5)
    #: retries after the first failed dispatch before failing over
    k.init("resolver_retry_budget", 2)
    #: initial retry backoff (exponential, jittered x[0.5, 1.5))
    k.init("resolver_retry_backoff", 0.05)
    #: fraction of healthy device batches cross-validated against a
    #: shadow-rebuilt oracle (corruption detector)
    k.init("resolver_probe_rate", 0.05)
    #: clean device-vs-oracle batches required to swap back after re-warm
    k.init("resolver_probation_batches", 4)
    #: batches served on the failover oracle before attempting a re-warm
    k.init("resolver_failover_min_batches", 4)
    #: admission fraction while any resolver engine is degraded
    k.init("resolver_degraded_tps_fraction", 0.25)
    # TPU conflict engine capacities (ours)
    k.init("conflict_table_capacity", 1 << 16)
    k.init("conflict_key_words", 4)
    k.init("conflict_max_batch_txns", 1 << 12)
    k.init("conflict_max_batch_ranges", 1 << 13)
    # Bucketed kernel ladder + budget-driven batching (docs/perf.md).
    #: comma-separated sub-capacity batch sizes compiled alongside the top
    #: shape ("512,1024"); empty = single bucket. Each must be a multiple
    #: of 32; an engine keeps only sizes below its own top shape (the
    #: global knob serves engines of every size), so oversized entries are
    #: ignored, not errors.
    k.init("resolver_bucket_ladder", "")
    #: client-observed p99 commit budget the adaptive batcher fits batches
    #: into — the resolver-inclusive share of the reference's < 3 ms
    #: end-to-end commit target (performance.rst:36,49; BASELINE.md's
    #: 1.5-2.5 ms window). bench.py's latency_under_load production-point
    #: filter reads the same knob.
    k.init("resolver_p99_budget_ms", 2.5)
    #: EWMA smoothing for observed per-bucket device latency (0 < a <= 1)
    k.init("resolver_latency_ewma_alpha", 0.25)
    #: history-query strategy of the conflict kernel (docs/perf.md
    #: "History search modes"): "fused_sort" re-sorts the capacity-H
    #: boundary table with every batch; "bsearch" sorts only the batch
    #: rows and binary-searches the already-sorted table; "auto" (default)
    #: picks per compiled bucket — bsearch when the batch rows are small
    #: relative to the table (T << H). Abort sets are bit-identical either
    #: way (the parity suite cross-checks the modes); this knob only moves
    #: device time. Engines take a `history_search=` constructor override.
    #: Deliberately no BUGGIFY randomizer: the modes are proven equivalent
    #: directly, and a randomizer draw would shift every sim's rng stream.
    k.init("resolver_history_search_mode", "auto")
    #: history STRUCTURE of the device interval table (docs/perf.md
    #: "Incremental history maintenance"): "monolithic" (default) re-merges
    #: the full capacity-H boundary table every batch; "tiered" appends
    #: each batch's committed-write union as a sorted run and compacts
    #: runs into the base table only when the run slots fill, so
    #: steady-state apply cost scales with the batch, not capacity, and
    #: MVCC-horizon/TTL GC becomes a range deletion (an elementwise
    #: horizon rebase; physical reclamation rides the lazy merge). Abort
    #: sets are bit-identical either way (the cross-structure parity
    #: suite pins it); this knob moves apply/GC device time. Engines take
    #: a `history_structure=` constructor override; a flip is a clean
    #: progcache miss (core/progcache.py key(structure=)). Deliberately
    #: no BUGGIFY randomizer: equivalence is proven directly, and a
    #: randomizer draw would shift every sim's rng stream.
    k.init("resolver_history_structure", "monolithic")
    #: run slots of the tiered history structure (KernelConfig
    #: .history_runs): how many sorted runs accumulate before the lazy
    #: device-side merge compacts them into the base table. More slots =
    #: cheaper steady-state applies but more run probes per query; >= 2
    #: required (one slot would merge every batch). Only read when the
    #: structure is "tiered".
    k.init("resolver_history_runs", 8)
    #: device-resident resolver loop (docs/perf.md "Device-resident
    #: loop"), consulted by the engine-mode router
    #: (host_engine.default_engine_mode — wall-clock nodes pick it up via
    #: `real/node.py --engine auto`): "" keeps step dispatch; "on" routes
    #: the single-chip engine through ops/device_loop.DeviceLoopEngine
    #: (persistent on-device server step, double-buffered queue,
    #: non-blocking result-ring drain); "pallas" additionally bakes the
    #: fused Pallas commit fixpoint (ops/fixpoint_pallas.py) into every
    #: loop body, with the interpreter fallback off-TPU. Abort sets are bit-identical in every
    #: mode (tests/test_device_loop.py); this knob only moves per-batch
    #: host/dispatch time. Deliberately no BUGGIFY randomizer: the modes
    #: are proven equivalent directly, and a draw would shift sim rng.
    k.init("resolver_device_loop", "")
    # Measured multi-device mesh resolution (docs/perf.md "Measured mesh
    # resolution"). Deliberately no BUGGIFY randomizers: the mesh modes
    # are proven verdict-identical to the serial oracle directly
    # (tests/test_mesh_parity.py) and a randomizer draw would shift
    # every sim's rng stream.
    #: devices the mesh engine spans: 0 = every visible XLA device; an
    #: explicit N takes the first N. Tests and `make mesh-smoke` force 8
    #: virtual CPU devices via XLA_FLAGS=--xla_force_host_platform_
    #: device_count=8, so mesh shapes are exercised without hardware.
    k.init("resolver_mesh_devices", 0)
    #: dispatch units the mesh result ring holds before the host drains
    #: the oldest — the double buffer: 2 keeps one batch's exchange
    #: collectives draining while the next batch's shard-local scan is
    #: already dispatched (parallel/mesh_engine.py)
    k.init("resolver_mesh_queue_depth", 2)
    #: "on" (default): overlapped dispatch — scan/exchange enqueue
    #: async, results drain through the non-blocking ring; "serial"
    #: forces every dispatch unit's outputs before the next enqueue (the
    #: A/B baseline tools/mesh_bench.py records as serialized_ms —
    #: overlapped must beat it)
    k.init("resolver_mesh_overlap", "on")
    # Observability (docs/observability.md).
    #: commit-path span collection (core/trace.py): 0 disables span
    #: recording entirely — instrumented sites pay one attribute check and
    #: allocate nothing (the near-zero-cost guarantee the regression test
    #: pins); > 0 enables collection (the value is reserved for per-batch
    #: sampling). Deliberately no BUGGIFY randomizer: span recording draws
    #: no rng, but enabling it mid-battery would grow the span buffer for
    #: nothing.
    k.init("trace_span_sample_rate", 0.0)
    # Distributed tracing (docs/observability.md "Distributed tracing").
    # Tail-based retention: the trace export decides WHICH traces to keep
    # after the outcome is known — every faulted/retried/throttled request
    # is always kept, plus the slowest clean acks as p99 candidates.
    # Deliberately no BUGGIFY randomizers: retention draws no rng and only
    # matters to wall-clock exports.
    #: fraction of the slowest clean acks retained as p99-candidate traces
    #: (0.02 = every ack at or above ~p98 — a margin around p99 wide
    #: enough that the p99 ack itself is always in the export)
    k.init("trace_tail_latency_frac", 0.02)
    #: hard cap on retained traces per export (report/JSON size bound;
    #: forced-retain error traces take precedence under the cap)
    k.init("trace_tail_max_traces", 512)
    #: dispatch records the ResilientEngine's flight recorder retains — the
    #: bounded ring dumped into quarantine/failover trace events for
    #: post-mortem replay (fault/resilient.py)
    k.init("resolver_flight_recorder_size", 64)
    # Keyspace heat & history-occupancy observability
    # (docs/observability.md "Keyspace heat & occupancy"). Deliberately no
    # BUGGIFY randomizers: heat is proven observational (bit-identical
    # abort sets either way) and a randomizer draw would shift sim rng.
    #: key-range histogram buckets the resolve step aggregates ON DEVICE
    #: per batch (boundary keys sampled from the interval table delimit
    #: them). 0 disables the whole layer: programs emit no heat outputs,
    #: engines build no aggregator, nothing allocates. Default 64 — the
    #: aggregate is a few KB riding an already-async readback, and the
    #: `conflict_heat` bench pins the device-time overhead < 3% at the
    #: production point.
    k.init("resolver_heat_buckets", 64)
    #: per-batch multiplicative decay of the host aggregator's key-range
    #: weights (core/heatmap.py): 1.0 = lifetime totals; 0.98 forgets a
    #: shifted hot spot in ~50 batches so split planning tracks the
    #: CURRENT load, the same windowing rationale as resolution_metrics
    k.init("resolver_heat_decay", 0.98)
    #: shards the aggregator proposes equal-load split points for — the
    #: measured input to multi-chip key-range sharding (ROADMAP item 1)
    k.init("resolver_heat_split_shards", 8)
    #: split-point hysteresis: a freshly derived equal-load split set
    #: replaces the last adopted one only when it improves the measured
    #: worst per-shard imbalance by at least this fraction — two adjacent
    #: scrapes of a stationary stream must not flap the resharding
    #: controller by one bucket (core/heatmap.py split_points)
    k.init("resolver_heat_split_hysteresis", 0.05)
    # Live elasticity: heat-driven online resolver resharding
    # (server/reshard.py; docs/elasticity.md). Deliberately no BUGGIFY
    # randomizers: the drift campaign stresses the controller directly,
    # and these only matter in wall-clock mode where buggify is off.
    #: admission fraction while a reshard is in flight — the ratekeeper
    #: clamps the published rate alongside watchdog_burn_tps_fraction
    #: until the handoff completes (server/ratekeeper.py)
    k.init("reshard_tps_fraction", 0.5)
    #: per-range blackout budget: the freeze -> cutover interval of one
    #: range handoff (the only window the moving range cannot serve) must
    #: stay under this, machine-asserted per executed reshard via the
    #: reshard.blackout trace segments (docs/elasticity.md "Blackout SLO")
    k.init("reshard_blackout_budget_ms", 250.0)
    #: controller evaluation cadence (heat scrape -> plan decision)
    k.init("reshard_eval_interval_s", 0.5)
    #: minimum wall-clock spacing between executed reshards — composes
    #: with the split-point hysteresis to keep the control loop stable
    k.init("reshard_min_interval_s", 1.0)
    #: split trigger: hottest shard's measured write+conflict load share
    #: above this plans a split of that shard at the heat-suggested key
    k.init("reshard_split_share", 0.55)
    #: merge trigger: an adjacent shard pair whose combined share is
    #: below this folds into one engine (frees capacity for hot splits)
    k.init("reshard_merge_share", 0.25)
    #: upper bound on live resolver shards the controller may create
    k.init("reshard_max_shards", 4)
    #: a reshard in flight longer than this is STALLED — the watchdog's
    #: ReshardStalledRule fires and the incident names the frozen range
    #: and the donor engine's health state (core/watchdog.py)
    k.init("reshard_stall_s", 3.0)
    # Performance observatory (docs/observability.md "Performance
    # observatory"). Deliberately no BUGGIFY randomizers: both layers are
    # observational (the ledger reads analysis off already-compiled
    # artifacts; sampling is counter-based and draws no rng), and a
    # randomizer draw would shift every sim's rng stream.
    #: per-compile records the engine's PerfLedger ring retains
    #: (core/perfledger.py: build duration + cost_analysis flops/bytes +
    #: memory_analysis peak HBM per (bucket, search mode, dispatch mode))
    k.init("resolver_perf_ledger_size", 128)
    #: fraction of dispatches that record a measured enqueue->ready
    #: device interval on the already-non-blocking drain paths (step
    #: force, fused scans, device-loop poll) — 1/rate rounds to a
    #: deterministic 1-in-N cadence, no rng; 0 disables. Abort sets are
    #: bit-identical on/off (tests/test_perf_ledger.py); engines take a
    #: `device_time_sample_rate=` constructor override.
    k.init("resolver_device_time_sample_rate", 0.0625)
    # Black-box journal & forensics (core/blackbox.py;
    # docs/observability.md "Black-box journal & forensics").
    # Deliberately no BUGGIFY randomizers: recording is observational
    # (abort sets bit-identical on/off) and draws no rng.
    #: master switch: "" = off (producer sites pay one list-index check
    #: and allocate nothing); "on" = journal into resolver_blackbox_dir;
    #: any other value is itself the journal directory
    k.init("resolver_blackbox", "")
    #: journal directory when resolver_blackbox is "on"
    k.init("resolver_blackbox_dir", "blackbox")
    #: segment rotation threshold: a segment reaching this many bytes is
    #: closed and a new one opened (append-only within a segment)
    k.init("resolver_blackbox_segment_bytes", 1 << 20)
    #: retained segments; the oldest is deleted past this (the journal's
    #: retention window — size it like the MVCC window so a replayed
    #: slice's too-old gate still covers the retained history)
    k.init("resolver_blackbox_segments", 8)
    #: in-memory ring of recent envelopes for live explain / summaries
    k.init("resolver_blackbox_ring", 4096)
    #: journal durability cadence: fsync the segment file every N records
    #: (1 = every record: acked implies durable — the crash campaign's
    #: child sets this so recovery never serves behind an ack). 0 keeps
    #: today's contract: flush per record (no data buffered in process)
    #: but no fsync — a power loss may eat the OS-buffered tail
    #: (docs/observability.md "crash-window contract")
    k.init("resolver_blackbox_fsync_interval", 0)
    # Crash-stop recovery (fault/recovery.py; docs/fault_tolerance.md
    # "Crash-stop recovery"). Deliberately no BUGGIFY randomizers: the
    # snapshot writer is observational and the crash campaign stresses
    # the recovery path directly.
    #: engine-state snapshot cadence in commit versions: the recovery
    #: manager writes a coalesced snapshot beside the journal segments
    #: every this-many versions (0 disables snapshotting — recovery
    #: falls back to full journal replay)
    k.init("resolver_recovery_snapshot_interval", 5000)
    #: recovery blackout SLO in ms: kill -> serving again, measured by
    #: the recovery.blackout span — the crash campaign machine-asserts
    #: every recovery under this (real/nemesis.py --crash)
    k.init("resolver_recovery_budget_ms", 5000.0)
    #: a recovery in flight longer than this is STALLED — the watchdog's
    #: RecoveryStalledRule fires (core/watchdog.py)
    k.init("resolver_recovery_stall_s", 10.0)
    # On-disk AOT program cache (core/progcache.py). Deliberately no
    # BUGGIFY randomizers: cache misses only cost a compile.
    #: master switch: "" = off (every program compiles); "on" = cache
    #: compiled artifacts under resolver_progcache_dir; any other value
    #: is itself the cache directory
    k.init("resolver_progcache", "")
    #: cache directory when resolver_progcache is "on"
    k.init("resolver_progcache_dir", "progcache")
    # Conflict-aware scheduler (pipeline/scheduler.py; docs/scheduling.md).
    # Deliberately no BUGGIFY randomizers: scheduling is deterministic
    # (counter-based probing, no rng) and the fully-off path must stay
    # byte-identical — a randomizer draw would shift every sim's stream.
    #: master switch: "" = off (admission hands batches through untouched,
    #: compiled programs byte-identical); "on" = predictive reorder +
    #: serialization lanes + pre-abort between admission and the batcher
    k.init("resolver_sched", "")
    #: max pending transactions the scheduler examines per batching tick
    #: (the reorder window; pendings beyond it keep arrival order)
    k.init("resolver_sched_window", 256)
    #: decayed conflict score at which a key range is HOT — hot ranges get
    #: a serialization lane and feed the doom predictor
    k.init("resolver_sched_hot_score", 4.0)
    #: per-tick multiplicative decay of range conflict scores (forgets
    #: cooled hot spots; pairs with resolver_heat_decay upstream). Ticks
    #: run at the batch cadence — hundreds per second — so the half-life
    #: at the default is tens of milliseconds, not seconds
    k.init("resolver_sched_decay", 0.98)
    #: pre-abort predicted-doomed transactions with
    #: transaction_conflict_predicted before device dispatch (clients
    #: refresh their read version and retry); False = predict + lane only
    k.init("resolver_sched_preabort", True)
    #: deterministic 1-in-N probe cadence: every Nth predicted-doomed
    #: transaction is dispatched anyway; a probe that COMMITS increments
    #: the mispredict counter the watchdog alerts on (no rng)
    k.init("resolver_sched_probe_interval", 16)
    #: upper bound on live serialization lanes (hottest ranges win;
    #: excess hot ranges fall back to reorder-only handling)
    k.init("resolver_sched_lane_max", 8)
    #: max transactions queued in one lane; a full lane stops capturing
    #: (overflow keeps normal batching) so lanes bound, never grow, work
    k.init("resolver_sched_lane_depth", 32)
    #: starvation bound: a transaction deferred this many ticks is
    #: dispatched regardless of predicted conflicts
    k.init("resolver_sched_defer_max", 4)
    #: watchdog threshold: probes that commit / probes dispatched above
    #: this fraction means the predictor has gone stale — sched_mispredict
    #: fires and the incident names the counter pair (core/watchdog.py)
    k.init("resolver_sched_mispredict_frac", 0.5)
    # Cluster watchdog (core/watchdog.py; docs/observability.md
    # "Watchdog, burn rates & incidents"). Deliberately no BUGGIFY
    # randomizers: evaluation is observational (host-side reads only,
    # no rng), and a randomizer draw would shift every sim's rng stream.
    #: master switch: off = `hub().sync()` pays one attribute check and
    #: allocates nothing (the NULL_SPAN-style regression guard); on = a
    #: default-ruleset watchdog attaches at hub construction and every
    #: sync evaluates the rules
    k.init("watchdog_enabled", False)
    #: bounded ring of alert lifecycle transitions the watchdog retains
    k.init("watchdog_alert_ring", 256)
    #: a rule's condition must hold this long before pending -> firing
    #: (discipline rules like blocking_syncs override to 0: a blocking
    #: sync is a fact, not a rate)
    k.init("watchdog_hold_s", 0.1)
    #: a firing rule's condition must stay clear this long to resolve
    k.init("watchdog_clear_s", 0.5)
    #: burn-rate fast/slow trailing windows — BOTH must burn above the
    #: threshold to fire (fast = detection latency, slow = flap guard)
    k.init("watchdog_burn_fast_s", 0.5)
    k.init("watchdog_burn_slow_s", 2.0)
    #: burn-rate multiplier over the error budget that fires (1.0 =
    #: budget spent exactly at the sustainable rate)
    k.init("watchdog_burn_threshold", 2.0)
    #: p99-vs-budget SLO error budget: allowed fraction of acks over the
    #: latency budget (0.01 = the p99 contract)
    k.init("watchdog_slo_bad_frac", 0.01)
    #: abort-fraction error budget (conflicts / resolved) — optimistic
    #: concurrency makes SOME aborts normal; a burn over this is hot-key
    #: collapse (the Zipf sweep measured 16%->43% with skew)
    k.init("watchdog_abort_budget_frac", 0.25)
    #: tenant throttle-rate error budget (rejected / offered)
    k.init("watchdog_throttle_budget_frac", 0.2)
    #: EWMA z-score band width for anomaly rules (heat concentration)
    k.init("watchdog_z_threshold", 3.5)
    #: a must-advance series (commit SLI total) frozen longer than this
    #: under evaluation is a stall
    k.init("watchdog_staleness_s", 1.5)
    #: admission fraction while a burn-rate alert is firing — the
    #: ratekeeper consumes the firing signal as a rate clamp alongside
    #: resolver_degraded (server/ratekeeper.py)
    k.init("watchdog_burn_tps_fraction", 0.5)
    # Wall-clock chaos (real/chaos.py; docs/real_cluster.md). Defaults for
    # the seeded NetworkNemesis' background fault mix — a campaign's
    # ChaosConfig reads these so `--knob`-style overrides steer injection
    # without touching campaign code. Deliberately no BUGGIFY randomizers:
    # these only matter in wall-clock mode, where buggify is off anyway.
    #: probability a request draws added one-way latency
    k.init("chaos_net_latency_prob", 0.05)
    #: the added latency when the draw fires (uniform in [0.5x, 1.5x])
    k.init("chaos_net_latency_ms", 2.0)
    #: probability a request frame is dropped on the floor (the client sees
    #: request_maybe_delivered, the redelivery semantics of the transport)
    k.init("chaos_net_drop_prob", 0.02)
    #: probability the peer connection is reset under a request
    k.init("chaos_net_reset_prob", 0.01)
    #: probability a fresh connection's handshake stalls (the peer accepts
    #: but never answers the hello; real_handshake_timeout_s must bound it)
    k.init("chaos_handshake_stall_prob", 0.05)
    # Disk nemesis (fault/inject.py DiskFaults + real/chaos.py
    # DiskNemesis): seeded fault mix for the durability surfaces — the
    # journal writer, the snapshot writer and the program cache. All
    # default 0: disk faults are campaign-armed, never ambient.
    #: probability a durable write stalls (a slow/contended fsync)
    k.init("chaos_disk_stall_prob", 0.0)
    #: stall length in ms when the draw fires (uniform in [0.5x, 1.5x])
    k.init("chaos_disk_stall_ms", 20.0)
    #: probability a write is TORN: only a prefix reaches the disk and
    #: the writer sees an IO error (the crash-mid-append shape)
    k.init("chaos_disk_torn_prob", 0.0)
    #: probability a write fails with ENOSPC (disk full)
    k.init("chaos_disk_enospc_prob", 0.0)
    #: probability a written payload suffers silent bit-rot (crc framing
    #: must catch it at read time and quarantine the data)
    k.init("chaos_disk_rot_prob", 0.0)
    #: wall-clock SLO scale: the chaos campaign's p99 budget is
    #: resolver_p99_budget_ms x this factor. The 2.5 ms budget prices a
    #: chip-adjacent resolver (sub-ms device time, in-rack RTT); the
    #: wall-clock mini-cluster the campaign drives pays ~1 ms in-process
    #: TCP RTT per hop plus a ~8 ms modeled service slot on a CI box, so
    #: its serving point sits ~24x higher. The ASSERTION CONTRACT is
    #: identical — p99 outside injected-fault windows <= the budget knob
    #: product — only the deployment's latency floor differs
    #: (docs/real_cluster.md).
    k.init("real_chaos_budget_factor", 24.0)
    #: per-tenant admission burst window in seconds (server/ratekeeper.py
    #: TenantAdmission token bucket: a tenant may burst rate*burst ahead)
    k.init("tenant_admission_burst_s", 0.5)
    return k


def _make_client_knobs() -> Knobs:
    k = Knobs()
    k.init("max_backoff", 1.0)
    k.init("initial_backoff", 0.01)
    k.init("backoff_growth_rate", 2.0)
    k.init("grv_batch_size_max", 1024)
    k.init("location_cache_size", 100_000)
    #: hedged reads (LoadBalance.actor.h second requests): after this long
    #: with no reply, race a second replica
    k.init("read_hedge_delay", 0.05, lambda r: 0.005 + r.random01() * 0.1)
    #: sampled transactions carry a debug id traced through the commit
    #: pipeline (g_traceBatch probes); 0 disables
    k.init("commit_sample_rate", 0.01, lambda r: r.random01() * 0.5)
    return k


def _make_flow_knobs() -> Knobs:
    k = Knobs()
    k.init("min_delay", 0.0001)
    k.init("max_buggified_delay", 0.2)
    k.init("connection_latency", 0.0005)
    # Real transport (real/transport.py; docs/real_cluster.md). These were
    # three hardcoded `timeout=5.0` sites and a magic sleep — promoted so a
    # chaos campaign (or an operator on a lossy link) can tune the failure
    # detection window without editing the transport.
    #: default per-request RPC timeout; request() callers may still pass an
    #: explicit timeout, which also rides the frame as a propagated
    #: deadline the server sheds expired work against
    k.init("real_rpc_timeout_s", 5.0)
    #: bound on the protocol-version handshake (a stalled or mismatched
    #: peer surfaces as connection_failed within this, never a hang)
    k.init("real_handshake_timeout_s", 5.0)
    #: first reconnect backoff after a failed connect (doubles per
    #: consecutive failure, jittered, until the max below; a request that
    #: lands inside the backoff window fails fast instead of hammering a
    #: dead peer with SYNs)
    k.init("real_reconnect_backoff_initial_s", 0.05)
    k.init("real_reconnect_backoff_max_s", 2.0)
    #: jitter half-width as a fraction of the backoff (0.5 = x[0.5, 1.5)),
    #: so a fleet of clients never reconnects in lockstep
    k.init("real_reconnect_backoff_jitter", 0.5)
    #: bound on the whole-cluster boot probe (real/cluster.py: every
    #: spawned node must accept a connection within this) — was a
    #: hardcoded `time.time() + 60`; promoted alongside the
    #: real_rpc_timeout_s family so slow CI boxes tune it by name
    k.init("real_cluster_boot_timeout_s", 60.0)
    return k


SERVER_KNOBS = _make_server_knobs()
CLIENT_KNOBS = _make_client_knobs()
FLOW_KNOBS = _make_flow_knobs()


def reset_all() -> None:
    """Restore every global registry to its defaults (undo per-simulation
    BUGGIFY randomization; the reference re-inits knobs per process)."""
    for live, make in ((SERVER_KNOBS, _make_server_knobs),
                       (CLIENT_KNOBS, _make_client_knobs),
                       (FLOW_KNOBS, _make_flow_knobs)):
        live._values.update(make()._values)


def randomize_all(rng, probability: float = 0.25) -> None:
    """BUGGIFY-randomize every registry (fdbserver/Knobs.cpp pattern:
    `init(KNOB, v); if(randomize && BUGGIFY) ...`)."""
    for k in (SERVER_KNOBS, CLIENT_KNOBS, FLOW_KNOBS):
        k.randomize(rng, probability)
