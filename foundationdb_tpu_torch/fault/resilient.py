"""ResilientEngine: the resolver survives a misbehaving device with
bit-identical abort sets.

Port of ``foundationdb_tpu/fault/resilient.py``: the same state machine,
shadow, watchdog, retries, probe, flight records, buggify sites and draw
order. On the card the device is a TorchConflictEngine (or the loop
engine) whose rewarm replays the shadow through its captured graphs.

The supervisor wraps the production conflict engine ("the device") and
pairs it with the reference-exact CPU oracle (ops/oracle.py) as a live
failover target, the Harmonia pattern (arXiv:1904.08964): the accelerated
path is fast, the authoritative path is always reconstructible.

Health state machine::

            dispatch fault                 retry budget exhausted
  HEALTHY ----------------> SUSPECT -----------------------------> FAILED
     ^       (retrying with jittered backoff,                        |
     |        device re-warmed before each retry)                    |
     |                                                               |
     |  probation_batches clean       failover_min_batches on the    |
     |  (device vs oracle equal)      oracle, then re-warm device    |
     +------------------- PROBATION <--------------------------------+
                              |
                              | device/oracle verdict mismatch
                              v                   (also from a sampled
                         QUARANTINED               probe in HEALTHY)

Why verdicts stay bit-identical through every transition: the supervisor
keeps a host-side shadow of the committed write history — one entry per
resolved batch, (version, committed write ranges, new_oldest), trimmed to
the window >= oldest_version. The oracle's own GC proof (ops/oracle.py:
any read passing the too-old gate has snapshot >= oldestVersion, so
intervals last written below the horizon can never conflict) means that
window is sufficient to rebuild the OBSERVABLE conflict state of any
engine from scratch: replaying the shadow's writes into a fresh oracle
(or back into a cleared device) yields the same verdict for every future
batch as an engine that lived through the whole history. Failover
mid-stream therefore changes nothing about abort sets, and the sampled
cross-validation probe (re-resolving a device batch on a shadow-rebuilt
oracle) is an exact corruption detector, not a heuristic.

Retries re-warm the device first because a failed dispatch may have
half-applied — or fully applied with the reply lost (the injector's
`applied_fraction` models this): re-running the batch against state that
already contains it would alias the batch's own writes into its history
and flip verdicts.
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

from ..core import blackbox, buggify, error, telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.rng import DeterministicRandom
from ..core.trace import Severity, TraceEvent, g_spans, span_event, span_now
from ..core.types import CommitTransaction, KeyRange, TransactionCommitResult
from ..ops.oracle import OracleConflictEngine
from ..sim.actors import any_of
from ..sim.loop import TaskPriority, current_scheduler, delay, spawn

HEALTHY = "healthy"
SUSPECT = "suspect"
FAILED = "failed"
PROBATION = "probation"
QUARANTINED = "quarantined"


@dataclass
class ResilienceConfig:
    """Supervisor knobs (docs/fault_tolerance.md). No field defaults: the
    single source of default values is the resolver_* knob registry
    (core/knobs.py), read at engine construction via from_knobs() so
    per-run knob overrides apply."""

    dispatch_timeout: float
    retry_budget: int
    retry_backoff: float
    probe_rate: float
    probation_batches: int
    failover_min_batches: int

    @classmethod
    def from_knobs(cls) -> "ResilienceConfig":
        k = SERVER_KNOBS
        return cls(
            dispatch_timeout=k.resolver_dispatch_timeout,
            retry_budget=k.resolver_retry_budget,
            retry_backoff=k.resolver_retry_backoff,
            probe_rate=k.resolver_probe_rate,
            probation_batches=k.resolver_probation_batches,
            failover_min_batches=k.resolver_failover_min_batches,
        )


def abort_set_digest(verdicts) -> str:
    """Stable 32-bit digest of a batch's verdict vector — the flight
    recorder's compact abort-set fingerprint. Replaying the batch through a
    clean oracle and digesting its verdicts must reproduce this exactly
    (DeviceFaultValidationWorkload's post-mortem parity check)."""
    return format(zlib.crc32(bytes(int(v) & 0xFF for v in verdicts)), "08x")


class FlightRecorder:
    """Bounded ring of recent device dispatches (docs/observability.md).

    A quarantine SevError used to say only "the device corrupted verdicts"
    with no record of the dispatches that led up to it; this ring keeps the
    last N dispatch records — version, txn/conflict-row counts, health
    state at dispatch, service latency, retries consumed, which path served
    (device/oracle), and the abort-set digest — and is dumped whole into
    the quarantine/failover trace events for post-mortem replay."""

    __slots__ = ("ring",)

    def __init__(self, size: Optional[int] = None):
        if size is None:
            size = int(SERVER_KNOBS.resolver_flight_recorder_size)
        self.ring: Deque[dict] = deque(maxlen=max(1, size))

    def record(self, **rec) -> None:
        self.ring.append(rec)

    def dump(self) -> List[dict]:
        return list(self.ring)

    def __len__(self) -> int:
        return len(self.ring)


class ResilientEngine:
    """Fault-tolerant supervisor over a device conflict engine."""

    name = "resilient"

    def __init__(self, device, cfg: Optional[ResilienceConfig] = None,
                 record_journal: bool = False,
                 oracle_factory=OracleConflictEngine):
        self.device = device
        self.cfg = cfg or ResilienceConfig.from_knobs()
        # own rng stream (one draw off the world's): per-batch probe and
        # backoff draws must not perturb the rest of the simulation
        self.rng = DeterministicRandom(
            current_scheduler().rng.random_int(0, 2**31 - 1))
        self.state = HEALTHY
        self.stats = {"batches": 0, "dispatch_faults": 0, "retries": 0,
                      "failovers": 0, "swap_backs": 0, "rewarm_failures": 0,
                      "probes": 0, "probe_mismatches": 0, "oracle_batches": 0}
        #: committed write history window: (version, ((begin, end), ...),
        #: new_oldest) per batch, trimmed to version >= the GC horizon
        self._shadow: Deque[Tuple] = deque()
        self._oldest = 0
        self._oracle_factory = oracle_factory
        self._failover: Optional[OracleConflictEngine] = None
        self._failed_batches = 0
        self._probation_left = 0
        #: (version, transactions, new_oldest, verdicts) per batch when
        #: journaling — the nemesis check replays it through a clean oracle
        #: to assert the emitted abort sets are bit-identical to a fault-free
        #: engine's. Off by default: the journal is unbounded by design
        #: (test-harness memory), so only sim campaigns opt in.
        self.journal: Optional[List[Tuple]] = [] if record_journal else None
        #: bounded ring of recent dispatches, dumped into quarantine/
        #: failover trace events (docs/observability.md)
        self.flight = FlightRecorder()
        #: per-batch retry bookkeeping for the flight record
        self._batch_retries = 0
        from . import register_engine

        register_engine(self)
        self._telemetry_label = telemetry.hub().register_health(self)
        telemetry.hub().record_health_transition(self._telemetry_label,
                                                 self.state)

    # -- public surface ------------------------------------------------------
    @property
    def degraded(self) -> bool:
        """True while the device is not serving cleanly: the pipeline
        collapses its window to depth 1 and the ratekeeper throttles."""
        return self.state != HEALTHY

    def health_stats(self) -> dict:
        return {"state": self.state, "degraded": self.degraded,
                "device": getattr(self.device, "name", type(self.device).__name__),
                "shadow_entries": len(self._shadow), **self.stats}

    def clear(self, version) -> None:
        self.device.clear(version)
        if self._failover is not None:
            self._failover.clear(version)
        self._shadow.clear()

    def warmup(self, **kw) -> "ResilientEngine":
        """Pass-through to a bucketed device engine's ladder warmup
        (ops/host_engine.py) so supervised serving is compile-stall-proof
        too; a no-op for engines without a ladder (the oracle)."""
        fn = getattr(self._rewarm_engine(), "warmup", None)
        if fn is not None:
            fn(**kw)
        return self

    def _rewarm_engine(self):
        """The engine whose device state/programs a re-warm rebuilds (the
        fault injector's rewarm_target bypasses the flaky dispatch path)."""
        target = self.device
        fn = getattr(target, "rewarm_target", None)
        return fn() if fn is not None else target

    def history_search_modes(self):
        """Pass-through to a bucketed device engine's resolved per-bucket
        history-search modes (docs/perf.md), so a supervised resolver's
        BudgetBatcher still keys its EWMAs per (bucket, mode); {} for
        engines without a ladder (the oracle)."""
        fn = getattr(self._rewarm_engine(), "history_search_modes", None)
        return fn() if fn is not None else {}

    def loop_stats_snapshot(self):
        """Pass-through to a device-loop engine's sync-accounting/occupancy
        snapshot (ops/device_loop.py) — the span/flight-record attachment
        survives supervision; None for step-dispatch engines."""
        fn = getattr(self._rewarm_engine(), "loop_stats_snapshot", None)
        return fn() if fn is not None else None

    def heat_snapshot(self, top_n: int = 8, brief: bool = False):
        """Pass-through to the device engine's keyspace-heat/occupancy
        snapshot (core/heatmap.py) — engine_health, spans and the flight
        recorder keep their heat context under supervision; None for
        engines without the layer (the oracle, heat off)."""
        fn = getattr(self._rewarm_engine(), "heat_snapshot", None)
        return fn(top_n=top_n, brief=brief) if fn is not None else None

    def history_stats_snapshot(self):
        """Pass-through to the device engine's tiered-history counters
        (ops/host_engine.py; docs/perf.md "Incremental history
        maintenance") — run-stack depth and append/merge totals stay
        visible under supervision; None for engines without the layer."""
        fn = getattr(self._rewarm_engine(), "history_stats_snapshot", None)
        return fn() if fn is not None else None

    def history_run_snapshots(self, since_runs=None):
        """Pass-through to the device engine's O(delta) run-snapshot
        export (fault/handoff.py run_slice consumes it on the donor side
        of a reshard) — None for monolithic devices, where the shadow
        replay is the only rebuild path."""
        fn = getattr(self._rewarm_engine(), "history_run_snapshots", None)
        return fn(since_runs=since_runs) if fn is not None else None

    async def resolve(self, transactions, now_v, new_oldest):
        """One batch through the supervisor; callers (server/resolver.py,
        pipeline/service.py) enter strictly in commit-version order."""
        self.stats["batches"] += 1
        self._batch_retries = 0
        t_dispatch = span_now()
        state_at_dispatch = self.state
        if self.state == FAILED:
            # re-warm BEFORE resolving this batch: the shadow and the
            # failover oracle are both exactly one-batch-behind states, so
            # the rebuilt device enters probation in lockstep
            self._maybe_rewarm()
        if self.state in (FAILED, QUARANTINED):
            verdicts = self._oracle_resolve(transactions, now_v, new_oldest)
            self._failed_batches += 1
        elif self.state == PROBATION:
            verdicts = await self._probation_batch(transactions, now_v, new_oldest)
        else:
            verdicts = await self._healthy_batch(transactions, now_v, new_oldest)
        self._record(now_v, transactions, new_oldest, verdicts)
        # flight records name the device's dispatch path and, for loop
        # engines, snapshot the queue/ring state at this dispatch — so a
        # quarantine dump from a loop-mode engine is diagnosable (was the
        # ring backed up? did a drain fall back to a blocking sync?)
        inner = self._rewarm_engine()
        loop_snap = self.loop_stats_snapshot()
        # heat/occupancy context rides next to the abort-set digest: a
        # quarantine or failover dump says whether the keyspace was hot
        # and how full the history table was when the batch ran
        # (docs/observability.md "Keyspace heat & occupancy")
        heat_snap = self.heat_snapshot(brief=True)
        self.flight.record(
            version=now_v,
            new_oldest=new_oldest,
            txns=len(transactions),
            reads=sum(len(t.read_conflict_ranges) for t in transactions),
            writes=sum(len(t.write_conflict_ranges) for t in transactions),
            state=state_at_dispatch,
            served_by=("device" if state_at_dispatch in (HEALTHY, SUSPECT)
                       else "oracle"),
            retries=self._batch_retries,
            ms=round((span_now() - t_dispatch) * 1e3, 4),
            digest=abort_set_digest(verdicts),
            dispatch_mode=getattr(inner, "dispatch_mode", "step"),
            **({"loop_stats": loop_snap} if loop_snap is not None else {}),
            **({"heat": heat_snap} if heat_snap is not None else {}),
        )
        return verdicts

    # -- state machine -------------------------------------------------------
    def _set_state(self, state: str) -> None:
        if state != self.state:
            TraceEvent("ResolverEngineHealth",
                       severity=(Severity.WARN if state != HEALTHY
                                 else Severity.INFO)) \
                .detail("From", self.state).detail("To", state).log()
            if blackbox.enabled():
                # the transition onto the durable black-box journal:
                # `cli explain` renders the failover/swap-back arc a
                # version's batch ran under, hours after the process died
                blackbox.record_health(self._telemetry_label,
                                       self.state, state)
            self.state = state
            # transition into the unified TDMetric registry: the change
            # history of this Int64 series IS the incident timeline
            telemetry.hub().record_health_transition(
                self._telemetry_label, state)

    async def _healthy_batch(self, transactions, now_v, new_oldest):
        try:
            got = await self._attempt(transactions, now_v, new_oldest,
                                      1 + max(0, self.cfg.retry_budget))
        except error.FDBError as e:
            self._fail_over(now_v, e)
            return self._oracle_resolve(transactions, now_v, new_oldest)
        if self.state == SUSPECT:
            self._set_state(HEALTHY)   # a retry recovered the device
        if self.cfg.probe_rate > 0 and self.rng.random01() < self.cfg.probe_rate:
            self.stats["probes"] += 1
            probe = self._rebuild_oracle()   # pre-batch: shadow excludes this batch
            want = probe.resolve(transactions, now_v, new_oldest)
            if [int(x) for x in got] != [int(x) for x in want]:
                self._quarantine(now_v, got, want)
                self._failover = probe       # already advanced past this batch
                return want
        return got

    async def _probation_batch(self, transactions, now_v, new_oldest):
        # the oracle stays authoritative: a device relapse mid-probation
        # cannot corrupt the emitted stream
        want = self._oracle_resolve(transactions, now_v, new_oldest)
        try:
            got = await self._attempt(transactions, now_v, new_oldest, 1)
        except error.FDBError as e:
            TraceEvent("ResolverEngineProbationFault").error(e).log()
            self._failed_batches = 0
            self._set_state(FAILED)
            return want
        self.stats["probes"] += 1
        if [int(x) for x in got] != [int(x) for x in want]:
            self._quarantine(now_v, got, want)
            return want
        self._probation_left -= 1
        if self._probation_left <= 0:
            self.stats["swap_backs"] += 1
            self._failover = None
            self._set_state(HEALTHY)
            TraceEvent("ResolverEngineSwapBack").detail("Version", now_v).log()
        return want

    async def _attempt(self, transactions, now_v, new_oldest, attempts: int):
        """Bounded watchdog-guarded dispatch attempts with jittered
        exponential backoff; device state is re-warmed from the shadow
        before every retry (the failed attempt may have applied)."""
        last: Optional[error.FDBError] = None
        for i in range(attempts):
            # retry time (backoff + re-warm + the re-dispatch itself) gets
            # its own span segment so latency attribution charges it to the
            # fault path, not to the healthy device-dispatch figure
            t_retry = span_now() if (i and g_spans.enabled) else None
            try:
                if i:
                    self.stats["retries"] += 1
                    self._batch_retries += 1
                    backoff = (self.cfg.retry_backoff * (2 ** (i - 1))
                               * (0.5 + self.rng.random01()))
                    await delay(backoff, TaskPriority.PROXY_RESOLVER_REPLY)
                    try:
                        self._rewarm_device()
                    except error.FDBError as e:
                        self.stats["rewarm_failures"] += 1
                        last = e
                        continue
                try:
                    return await self._dispatch_once(transactions, now_v, new_oldest)
                except error.FDBError as e:
                    self.stats["dispatch_faults"] += 1
                    if self.state == HEALTHY:
                        self._set_state(SUSPECT)
                    last = e
            finally:
                if t_retry is not None and g_spans.enabled:
                    span_event("resolver.retry", now_v, t_retry, span_now(),
                               attempt=i, parent="resolver.device_dispatch")
        raise last if last is not None else error.device_fault("no attempts")

    async def _dispatch_once(self, transactions, now_v, new_oldest):
        if buggify.buggify():
            # engine-boundary fault: every sim spec (attrition, clogging,
            # recovery) exercises the watchdog/retry path for free
            raise error.device_fault("buggify: dispatch failed at engine boundary")
        if buggify.buggify():
            # straggling device: completes, but late
            await delay(self.cfg.dispatch_timeout * 0.5,
                        TaskPriority.PROXY_RESOLVER_REPLY)
        eng = self.device
        if not hasattr(eng, "resolve_async"):
            # synchronous engine: runs inline in zero virtual time (cannot
            # hang); exceptions propagate to the retry loop
            try:
                return eng.resolve(transactions, now_v, new_oldest)
            except error.FDBError:
                raise
            except Exception as e:
                raise error.device_fault(f"device dispatch raised: {e}") from e
        task = spawn(self._run_async(eng, transactions, now_v, new_oldest),
                     TaskPriority.PROXY_RESOLVER_REPLY, name="deviceDispatch")
        timer = delay(self.cfg.dispatch_timeout, TaskPriority.PROXY_RESOLVER_REPLY)
        try:
            idx, value = await any_of([task, timer])
        except BaseException:
            # our own cancellation (role killed mid-dispatch) must not
            # leave a hung device task orphaned behind the dead role
            task.cancel()
            raise
        if idx == 1:
            task.cancel()
            raise error.device_fault(
                f"dispatch watchdog: no completion in {self.cfg.dispatch_timeout}s")
        return value

    async def _run_async(self, eng, transactions, now_v, new_oldest):
        try:
            return await eng.resolve_async(transactions, now_v, new_oldest)
        except error.FDBError:
            raise
        except Exception as e:
            raise error.device_fault(f"device dispatch raised: {e}") from e

    def _fail_over(self, now_v, err) -> None:
        """Persistent device failure: rebuild the CPU oracle from the
        shadow (one-batch-behind state) and serve from it mid-stream."""
        self.stats["failovers"] += 1
        self._failover = self._rebuild_oracle()
        self._failed_batches = 0
        self._set_state(FAILED)
        if blackbox.enabled():
            blackbox.record_flight("failover", now_v, self.flight.dump())
        TraceEvent("ResolverEngineFailover", severity=Severity.WARN) \
            .detail("Version", now_v).detail("ShadowEntries", len(self._shadow)) \
            .detail("FlightRecorder", self.flight.dump()) \
            .error(err).log()

    def _maybe_rewarm(self) -> None:
        """After enough batches on the oracle, try to re-warm device state
        from the shadow and enter probation; a re-warm failure leaves us on
        the oracle for another round."""
        if self._failed_batches < max(1, self.cfg.failover_min_batches):
            return
        self._failed_batches = 0
        try:
            self._rewarm_device()
        except error.FDBError as e:
            self.stats["rewarm_failures"] += 1
            TraceEvent("ResolverEngineRewarmFailed").error(e).log()
            return
        self._probation_left = max(1, self.cfg.probation_batches)
        self._set_state(PROBATION)

    def _quarantine(self, now_v, got, want) -> None:
        """The probe caught the device disagreeing with the shadow-rebuilt
        oracle: silent corruption. SevError — a correctness event — and the
        device is never trusted again this incarnation."""
        self.stats["probe_mismatches"] += 1
        self._set_state(QUARANTINED)
        if blackbox.enabled():
            blackbox.record_flight("quarantine", now_v, self.flight.dump())
        # the flight recorder's last N dispatch records ride the SevError:
        # a post-mortem replays them (digests + journal) without having to
        # reconstruct the dispatch history from scattered logs
        TraceEvent("ResolverEngineQuarantine", severity=Severity.ERROR) \
            .detail("Version", now_v) \
            .detail("Got", [int(x) for x in got]) \
            .detail("Want", [int(x) for x in want]) \
            .detail("FlightRecorder", self.flight.dump()).log()

    # -- shadow history ------------------------------------------------------
    def _oracle_resolve(self, transactions, now_v, new_oldest):
        self.stats["oracle_batches"] += 1
        return self._failover.resolve(transactions, now_v, new_oldest)

    def _record(self, now_v, transactions, new_oldest, verdicts) -> None:
        committed = int(TransactionCommitResult.COMMITTED)
        writes = tuple(
            (r.begin, r.end)
            for t, txn in enumerate(transactions)
            if int(verdicts[t]) == committed
            for r in txn.write_conflict_ranges
            if r.begin < r.end
        )
        self._shadow.append((now_v, writes, new_oldest))
        if new_oldest > self._oldest:
            self._oldest = new_oldest
        while self._shadow and self._shadow[0][0] < self._oldest:
            self._shadow.popleft()
        if self.journal is not None:
            self.journal.append((now_v, tuple(transactions), new_oldest,
                                 tuple(int(v) for v in verdicts)))

    def _rebuild_oracle(self) -> OracleConflictEngine:
        o = self._oracle_factory()
        self._replay_shadow(o)
        return o

    def _rewarm_device(self) -> None:
        if buggify.buggify():
            # re-warm itself can fail (the device is, after all, sick)
            raise error.device_fault("buggify: device re-warm failed")
        target = self._rewarm_engine()
        try:
            self._replay_shadow(target)
            # Bucketed engines: the shadow replay rebuilds device STATE;
            # program coverage persists across clear(), so only ladder
            # buckets that actually served traffic get (re-)warmed — a
            # rebuild never front-loads compiles for shapes this stream
            # has not used.
            fn = getattr(target, "ensure_warm", None)
            if fn is not None:
                fn(used_only=True)
        except error.FDBError:
            raise
        except Exception as e:
            raise error.device_fault(f"device re-warm raised: {e}") from e

    def _replay_shadow(self, eng) -> None:
        """Rebuild an engine's observable conflict state from the shadow.

        Sufficiency: any read that passes the too-old gate has
        read_snapshot >= oldest_version, so intervals last written below
        the horizon compare <= snapshot and can never conflict — only the
        window >= oldest_version (exactly what the shadow keeps) decides
        verdicts (the same argument that makes the oracle's GC
        representation-only)."""
        # A device-loop engine's clear() drains its in-flight queue slots
        # before touching the donated table (ops/device_loop.py enforces
        # the drain-before-host-touch contract engine-side), so this
        # rebuild needs no engine-specific handling.
        eng.clear(0)
        if self._oldest:
            # pin the too-old gate first; per-entry horizons below it are
            # then no-ops and GC timing differences are representation-only
            eng.resolve([], self._oldest, self._oldest)
        for version, writes, new_oldest in self._shadow:
            if not writes:
                continue
            txn = CommitTransaction(
                read_snapshot=version,
                write_conflict_ranges=[KeyRange(b, e) for b, e in writes])
            eng.resolve([txn], version, new_oldest)
