"""Virtual-time pipelined resolution service for the sim cluster.

Port of ``foundationdb_tpu/pipeline/service.py``.

The deterministic simulation runs the conflict engine's host compute in
zero virtual time, so the one-batch-at-a-time resolver shows NO service
time at all — nothing in the e2e sim ever measured what the resolver's
real pack/device costs do to client-observed commit latency (VERDICT r5
weak #2). This service is the sim analog of ResolverPipeline: the same
window/stage structure, with the wall-clock pack and device times
INJECTED as virtual-time delays (chip_smoke.py's role phase feeds in the
card's own pack clock and sampled device ms per bucket), so the e2e cluster's
commit-latency distribution reflects the measured hardware.

Stage model, exactly the overlap the wall-clock pipeline gives:

  * a window of `depth` batches may be in service at once (acquire());
  * each batch pays a host pack delay (linear in its transaction count) —
    packs of different batches overlap each other and the device;
  * the DEVICE is serial: batch i+1's program starts only after batch i's
    finished, in commit-version order — verdicts are computed by the real
    engine at that point, so abort sets are bit-identical to the serial
    resolver (same engine calls, same order);
  * depth 1 degenerates to pack + device back-to-back with no overlap —
    the serial baseline.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from ..core import buggify
from ..core.trace import g_spans, span_event, span_now
from ..sim.actors import NotifiedVersion
from ..sim.loop import Promise, TaskPriority, delay
from .resolver_pipeline import BudgetBatcher


@dataclass
class PipelineConfig:
    """Knobs of the pipelined resolver service (docs/pipeline.md,
    docs/perf.md).

    depth               — in-flight window: 1 = serial, 2 = double
                          buffering (pack overlaps device), 3 = triple.
    pack_ms_per_txn     — host packing cost, linear in batch size
                          (bench.py: host_pack_ms_per_batch / batch_txns).
    device_ms_per_batch — device program time for the compiled batch shape
                          (constant per dispatch; bench.py measure_scan).
    max_batch_txns      — the compiled kernel's top-bucket T: proxies must
                          not send larger batches (server/proxy.py
                          max_commit_batch is sized to it).
    device_ms_by_bucket — bucketed kernel ladder: measured device ms per
                          compiled bucket shape {T: ms} (bench.py
                          bucket_ladder section). When set, a batch pays
                          its own bucket's device time — not the top
                          shape's — and the service's BudgetBatcher
                          adaptively targets the largest bucket whose
                          predicted latency fits p99_budget_ms.
    p99_budget_ms       — commit-latency budget the adaptive target fits
                          (None = the resolver_p99_budget_ms knob).
    search_mode_by_bucket — resolved history-search mode per bucket
                          {T: "fused_sort" | "bsearch"} (docs/perf.md;
                          an engine's history_search_modes()). Keys the
                          BudgetBatcher's per-(bucket, mode) EWMAs so a
                          mode flip never poisons the other mode's
                          latency estimate.
    sched               — conflict-aware admission scheduling
                          (pipeline/scheduler.py, docs/scheduling.md):
                          "" = the resolver_sched knob decides, "on" /
                          "off" force it for this service. The service
                          resolves batches whose versions are already
                          assigned, so it never reorders; it OWNS the
                          shared ConflictScheduler instance — admission
                          layers call service.conflict_sched.select(),
                          and resolve() trains the predictor on every
                          batch's verdicts regardless of who admitted it.
    dispatch_mode       — how batches reach the device (docs/perf.md
                          "Device-resident loop"): "step" is the
                          launch-per-batch path whose device segment is
                          one opaque span; "device_loop" models the
                          device-resident server loop — the device span
                          splits into queue_enqueue / device_resident /
                          result_drain segments and the BudgetBatcher
                          files EWMAs under the "loop" dispatch key.
    queue_enqueue_ms    — loop mode: host cost to pack a queue slot and
                          async-dispatch the server step (no sync).
    result_drain_ms     — loop mode: host cost to poll + decode the
                          batch's abort bitmaps from the result ring
                          (non-blocking in steady state).
    """

    depth: int = 2
    pack_ms_per_txn: float = 0.0
    device_ms_per_batch: float = 0.0
    max_batch_txns: int = 4096
    device_ms_by_bucket: Optional[Dict[int, float]] = None
    p99_budget_ms: Optional[float] = None
    search_mode_by_bucket: Optional[Dict[int, str]] = None
    dispatch_mode: str = "step"
    queue_enqueue_ms: float = 0.0
    result_drain_ms: float = 0.0
    sched: str = ""

    def as_dict(self) -> dict:
        return {"depth": self.depth,
                "pack_ms_per_txn": self.pack_ms_per_txn,
                "device_ms_per_batch": self.device_ms_per_batch,
                "max_batch_txns": self.max_batch_txns,
                "device_ms_by_bucket": (dict(self.device_ms_by_bucket)
                                        if self.device_ms_by_bucket else None),
                "p99_budget_ms": self.p99_budget_ms,
                "search_mode_by_bucket": (dict(self.search_mode_by_bucket)
                                          if self.search_mode_by_bucket
                                          else None),
                "dispatch_mode": self.dispatch_mode,
                "queue_enqueue_ms": self.queue_enqueue_ms,
                "result_drain_ms": self.result_drain_ms,
                "sched": self.sched}


#: the service's dispatch modes (PipelineConfig.dispatch_mode)
DISPATCH_MODES = ("step", "device_loop")


class PipelinedResolverService:
    """One resolver role's service pipeline (owned by server/resolver.py)."""

    def __init__(self, cfg: PipelineConfig, engine):
        if cfg.dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch_mode {cfg.dispatch_mode!r} is not one of "
                             f"{DISPATCH_MODES}")
        self.cfg = cfg
        self.engine = engine
        self._in_use = 0
        self._waiters: deque = deque()
        self._seq = 0
        #: sequence number of the newest batch whose device stage finished
        self._device_done = NotifiedVersion(0)
        #: budget-driven batch sizing over the bucket ladder (None without
        #: a per-bucket device-time table): virtual-time service delays
        #: feed the EWMA; target_batch_txns() is the adaptive production
        #: point the proxy's commit batcher is capped to (via ratekeeper)
        #: shared conflict scheduler (pipeline/scheduler.py): the service
        #: owns the instance and trains its predictor on every resolved
        #: batch; admission layers consult it for select()/pre-abort.
        #: Config "" defers to the resolver_sched knob, "on"/"off" force.
        from .scheduler import ConflictScheduler, SchedConfig

        sched_cfg = SchedConfig.from_knobs()
        if cfg.sched:
            sched_cfg.enabled = cfg.sched.strip().lower() == "on"
        self.conflict_sched = ConflictScheduler(
            sched_cfg, heat=getattr(engine, "heat", None))
        self.batcher: Optional[BudgetBatcher] = None
        if cfg.device_ms_by_bucket:
            bucket_modes = dict(cfg.search_mode_by_bucket or {})
            if not bucket_modes and hasattr(engine, "history_search_modes"):
                bucket_modes = engine.history_search_modes()
            self.batcher = BudgetBatcher(
                ladder=list(cfg.device_ms_by_bucket),
                budget_ms=cfg.p99_budget_ms,
                pack_ms_per_txn=cfg.pack_ms_per_txn,
                seed_ms={int(t): float(v)
                         for t, v in cfg.device_ms_by_bucket.items()},
                bucket_modes=bucket_modes,
                # EWMAs file under the dispatch path serving this
                # resolver, so a device-loop rollout never poisons the
                # step path's estimates (docs/perf.md)
                dispatch_mode=("loop" if cfg.dispatch_mode == "device_loop"
                               else getattr(engine, "dispatch_mode", "step")),
            )

    @property
    def in_flight(self) -> int:
        return self._in_use

    def target_batch_txns(self) -> int:
        """Adaptive batch-size target (falls back to the static top shape
        without a ladder). Degradation (fault/resilient.py) clamps to the
        smallest bucket on top of the depth-1 window collapse."""
        if self.batcher is None:
            return self.cfg.max_batch_txns
        return self.batcher.target_batch_txns(
            self.cfg.depth, degraded=getattr(self.engine, "degraded", False))

    def _device_ms(self, n_txns: int) -> float:
        """Injected device time for one batch: under a ladder, each chunk
        the engine packs it into pays its own bucket's measured per-chunk
        program time (a light batch no longer pays the top shape's device
        time; a batch above max_batch_txns, which proxies should not send,
        pays one chunk per full max_batch_txns plus its remainder's
        chunk), else the flat per-batch figure."""
        if self.batcher is None:
            return self.cfg.device_ms_per_batch
        by_bucket = self.cfg.device_ms_by_bucket or {}

        def chunk_ms(n: int) -> float:
            ms = by_bucket.get(self.batcher.bucket_of(n))
            return self.cfg.device_ms_per_batch if ms is None else ms

        top = self.cfg.max_batch_txns
        full, rest = divmod(n_txns, top)
        return full * chunk_ms(top) + (chunk_ms(rest) if rest or not full else 0.0)

    def _capacity(self) -> int:
        """Effective window: a degraded engine (fault/resilient.py —
        retrying, failed over, or on probation) collapses the pipeline to
        depth 1 so we stop piling dispatches onto a sick device; the full
        window re-opens on swap-back."""
        if getattr(self.engine, "degraded", False):
            return 1
        return max(1, self.cfg.depth)

    async def acquire(self) -> None:
        """Take a window slot; blocks while the effective window is full
        (the resolver's backpressure onto the proxy's commit window)."""
        while self._in_use >= self._capacity():
            p = Promise()
            self._waiters.append(p)
            try:
                await p.future   # woken by release(); capacity re-checked
            except BaseException:
                if p.is_set:
                    # release() woke us while we were being cancelled:
                    # pass the wake-up on rather than losing it
                    self._wake()
                else:
                    self._waiters.remove(p)
                raise
        self._in_use += 1

    def release(self) -> None:
        self._in_use -= 1
        self._wake()

    def _wake(self) -> None:
        if self._waiters and self._in_use < self._capacity():
            self._waiters.popleft().send(None)

    async def resolve(self, transactions, version, new_oldest):
        """Run one accepted batch through pack -> device -> verdicts.
        Callers hold a window slot and enter in commit-version order (the
        resolver's version chain guarantees it); the slot is released here
        when the batch completes. With span collection on (core/trace.py)
        each stage emits a segment keyed by the commit version: host pack,
        pipeline wait (the in-order device chain), device dispatch, and the
        force/verdict-materialization tail — the decomposition bench.py's
        `latency_attribution` reassembles against client-observed latency."""
        self._seq += 1
        seq = self._seq
        spans_on = g_spans.enabled
        try:
            t0 = span_now() if spans_on else 0.0
            pack_ms = self.cfg.pack_ms_per_txn * len(transactions)
            if buggify.buggify():
                # jittered host pack: batches arrive at the device stage
                # out of rhythm, stressing the in-order device chain
                pack_ms = pack_ms * 5 + 0.05
            if pack_ms > 0:
                await delay(pack_ms / 1e3, TaskPriority.PROXY_RESOLVER_REPLY)
            if spans_on:
                t1 = span_now()
                span_event("resolver.host_pack", version, t0, t1,
                           txns=len(transactions),
                           parent="resolver.queue_wait")
            await self._device_done.when_at_least(seq - 1)
            from ..sim.loop import now as _now

            loop_mode = self.cfg.dispatch_mode == "device_loop"
            if spans_on:
                t2 = span_now()
                span_event("resolver.pipeline_wait", version, t1, t2,
                           parent="resolver.queue_wait")
            if loop_mode and self.cfg.queue_enqueue_ms > 0:
                # loop mode: the host's enqueue share — pack the queue
                # slot + async-dispatch the server step (no sync)
                await delay(self.cfg.queue_enqueue_ms / 1e3,
                            TaskPriority.PROXY_RESOLVER_REPLY)
            if spans_on and loop_mode:
                t2 = span_now()
                span_event("resolver.queue_enqueue", version,
                           t2 - self.cfg.queue_enqueue_ms / 1e3, t2,
                           txns=len(transactions),
                           parent="resolver.queue_wait")
            t_dev = _now()
            verdicts = self.engine.resolve(transactions, version, new_oldest)
            if hasattr(verdicts, "__await__"):
                # supervised engine (fault/resilient.py): the dispatch may
                # retry/fail over under its watchdog before verdicts land
                verdicts = await verdicts
            device_ms = self._device_ms(len(transactions))
            if device_ms > 0:
                await delay(device_ms / 1e3, TaskPriority.PROXY_RESOLVER_REPLY)
            if spans_on:
                t3 = span_now()
                # step mode: the device segment covers the engine dispatch
                # (including any supervisor watchdog/retry time — the retry
                # share is emitted separately as resolver.retry by
                # fault/resilient.py) plus the injected program time for
                # this batch's bucket. Loop mode splits the same interval:
                # the device-resident share here, the host's enqueue/drain
                # shares as their own segments — the attribution that
                # latency_attribution reassembles for the loop path. A real
                # loop engine behind this service (device_loop service
                # mode) attaches its batch-time loop_stats snapshot —
                # queue/ring occupancy and the sync accounting — to the
                # device_resident span, so a slow batch's trace says
                # whether the ring was backed up when it ran.
                extra = {}
                if loop_mode:
                    snap_fn = getattr(self.engine, "loop_stats_snapshot",
                                      None)
                    snap = snap_fn() if snap_fn is not None else None
                    if snap is not None:
                        extra["loop_stats"] = snap
                # keyspace-heat context (core/heatmap.py): the batch-time
                # hot-range pressure rides the device span, so a slow
                # batch's trace says whether the keyspace was hot
                heat_fn = getattr(self.engine, "heat_snapshot", None)
                if heat_fn is not None:
                    heat = heat_fn(brief=True)
                    if heat is not None:
                        extra["heat"] = heat
                span_event("resolver.device_resident" if loop_mode
                           else "resolver.device_dispatch",
                           version, t2, t3, txns=len(transactions),
                           parent="resolver.queue_wait", **extra)
            if loop_mode and self.cfg.result_drain_ms > 0:
                # loop mode: the host's drain share — non-blocking poll +
                # bitmap decode off the result ring
                await delay(self.cfg.result_drain_ms / 1e3,
                            TaskPriority.PROXY_RESOLVER_REPLY)
            if spans_on and loop_mode:
                t3b = span_now()
                span_event("resolver.result_drain", version, t3, t3b,
                           parent="resolver.queue_wait")
                t3 = t3b   # the force tail starts after the drain segment
            if self.batcher is not None:
                # observed device-stage time: injected program time plus any
                # real engine/supervisor stalls (watchdog retries, failover)
                # — exactly what balloons the EWMA and degrades the target
                self.batcher.observe(
                    self.batcher.bucket_of(len(transactions)),
                    (_now() - t_dev) * 1e3)
            if spans_on:
                # verdict materialization / readback tail: zero virtual time
                # in the sim model (readback rides the injected device
                # figure); named so the wall-clock pipeline's real force
                # segment and the sim's line up in attribution output
                span_event("resolver.force", version, t3, span_now(),
                           parent="resolver.queue_wait")
            if self.conflict_sched.enabled and transactions:
                # predictor feedback at the resolution point: every batch
                # trains the doom model, whichever layer admitted it
                self.conflict_sched.observe_batch(
                    list(transactions), verdicts, version)
            return verdicts
        finally:
            # On any exit (including cancellation mid-wait) unblock the
            # successor's device wait and hand the slot on — a wedged chain
            # would stall every later batch forever.
            self._device_done.advance(seq)
            self.release()
