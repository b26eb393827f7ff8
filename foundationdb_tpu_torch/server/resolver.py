"""Resolver: OCC conflict detection behind the ConflictSet interface.

Port of ``foundationdb_tpu/server/resolver.py``.

Re-design of fdbserver/Resolver.actor.cpp (320 LoC): batches are serialized
into the global commit order by (prev_version -> version) chaining
(resolveBatch:110 `version.whenAtLeast(req.prevVersion)`), each batch runs
through a pluggable ConflictSet engine — the reference-exact oracle or the
port's card engines (TorchConflictEngine, DeviceLoopEngine) — and the GC horizon advances to
version - MAX_WRITE_TRANSACTION_LIFE_VERSIONS (SkipList removeBefore).

The engine's resolve() is synchronous from the actor's point of view: in
simulation the engine's pack + dispatch + force run inline on the one
logical device queue (the force is the batch's only wait, never a host
sync inside the dispatch), which keeps runs deterministic (SURVEY.md §5
race-detection strategy). The engine draws nothing from the simulation's
random stream, so a card engine and a CPU engine take the same buggify
decisions from the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core import blackbox, buggify, error
from ..core import telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.stats import CounterCollection
from ..core.trace import g_spans, span_event, span_now
from ..core.types import (
    CommitTransaction,
    KeyRange,
    MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
    Version,
)
from ..pipeline.service import PipelineConfig, PipelinedResolverService
from ..sim.actors import NotifiedVersion
from ..sim.loop import Promise, TaskPriority, spawn
from ..sim.network import SimProcess
from .messages import ResolveTransactionBatchRequest, ResolveTransactionBatchReply

RESOLVE_TOKEN = "resolver.resolve"
RESOLUTION_METRICS_TOKEN = "resolver.metrics"
RESOLVER_HEALTH_TOKEN = "resolver.health"

#: reservoir size for the split-key sample (the analog of the resolver's
#: iops TransientStorageMetricSample feeding ResolutionSplitRequest)
KEY_SAMPLE_SIZE = 64

#: virtual end of the conflict keyspace for whole-span synthetic writes
#: (above every real key, including the \xff system space and the cluster
#: shard end \xff\xff\xff)
CONFLICT_KEYSPACE_END = b"\xff\xff\xff\xff\xff"


def _span_of(splits: tuple, i: int) -> tuple:
    """Resolver i's key span under `splits` (n-1 split keys)."""
    begins = [b""] + list(splits)
    b = begins[i] if i < len(begins) else begins[-1]
    e = begins[i + 1] if i + 1 < len(begins) else CONFLICT_KEYSPACE_END
    return b, e


def gained_ranges(old_splits: tuple, new_splits: tuple, i: int) -> list:
    """The key ranges resolver i owns under new_splits but not under
    old_splits — the incoming spans of a live rebalance."""
    nb, ne = _span_of(new_splits, i)
    ob, oe = _span_of(old_splits, i)
    out = []
    if nb < ob:
        out.append((nb, min(ne, ob)))
    if ne > oe:
        out.append((max(nb, oe), ne))
    return [(b, e) for b, e in out if b < e]


#: shared with the telemetry hub's health sync, which exports the same
#: figures as `resolver.<label>.state_bytes`/`state_memory_pressure`
#: series for the watchdog's pressure rule (core/telemetry.py)
_engine_state_bytes = telemetry._engine_state_bytes


class Resolver:
    def __init__(self, proc: SimProcess, engine, start_version: Version = 0,
                 token_suffix: str = "", index: int = 0,
                 pipeline: Optional[PipelineConfig] = None):
        """`engine` implements resolve(transactions, now, new_oldest) and
        clear(version) — OracleConflictEngine, TorchConflictEngine or
        DeviceLoopEngine (ops/). token_suffix scopes the
        endpoint to one recovery generation; `index` is this resolver's
        key-shard slot (live rebalancing computes its gained spans).
        `pipeline` turns the one-batch-at-a-time path into the windowed
        multi-batch in-flight service (pipeline/service.py): up to
        `pipeline.depth` batches overlap pack/device stages, verdicts stay
        bit-identical to the serial path."""
        from ..sim.loop import current_scheduler

        self.proc = proc
        self.engine = engine
        self.index = index
        #: newest routing flip already seeded into the engine
        self._flip_seen: Version = 0
        self.version = NotifiedVersion(start_version)
        self.token = RESOLVE_TOKEN + token_suffix
        self.metrics_token = RESOLUTION_METRICS_TOKEN + token_suffix
        self.health_token = RESOLVER_HEALTH_TOKEN + token_suffix
        # replay window: version -> reply, for proxy retries after
        # request_maybe_delivered (reference keeps recentStateTransactions)
        self._recent: Dict[Version, ResolveTransactionBatchReply] = {}
        #: versions accepted into the pipeline but not yet resolved: a
        #: duplicate delivery awaits the in-flight future instead of
        #: missing the replay window
        self._inflight: Dict[Version, Promise] = {}
        self._service = (PipelinedResolverService(pipeline, engine)
                         if pipeline is not None else None)
        #: conflict-range rows since the last metrics poll + a reservoir
        #: sample of range-begin keys (reference: ResolutionMetricsRequest /
        #: ResolutionSplitRequest, Resolver.actor.cpp:276-284)
        self._rows_since_poll = 0
        self._rows_total = 0
        self._key_sample: list = []
        self._sample_rng = current_scheduler().rng
        #: reference: Resolver.actor.cpp's resolverCounters via traceCounters
        #: — the logger is a real scheduled task (cancelled on unregister),
        #: not a dropped coroutine, so resolver counters actually trace.
        #: Counters also feed the unified telemetry hub's TDMetric registry
        #: (core/telemetry.py), so a MetricLogger persists them alongside
        #: engine perf / batcher / health series.
        self.stats = CounterCollection("Resolver", proc.address,
                                       tdmetrics=telemetry.hub().tdmetrics)
        self._stats_task = spawn(self.stats.run_logger(),
                                 TaskPriority.RESOLUTION_METRICS,
                                 name="resolverStats")
        proc.actors.add(self._stats_task)
        proc.register(self.token, self.resolve_batch)
        proc.register(self.metrics_token, self.resolution_metrics)
        proc.register(self.health_token, self.engine_health)

    def unregister(self) -> None:
        self.proc.unregister(self.token)
        self.proc.unregister(self.metrics_token)
        self.proc.unregister(self.health_token)
        self._stats_task.cancel()

    async def engine_health(self, _req) -> dict:
        """Engine-health fragment (the device-fault analog of
        ResolutionMetricsRequest): the ratekeeper polls it as a throttle
        signal and the status document surfaces it (tools/cli.py). A
        budget-batching pipeline additionally reports its adaptive batch
        target, which the ratekeeper relays to proxies as the commit-batch
        cap (the resolver -> ratekeeper -> proxy sizing loop)."""
        out = {"state": "healthy", "degraded": False}
        fn = getattr(self.engine, "health_stats", None)
        if fn is not None:
            out.update(fn())
        out["resolve_errors"] = self.stats.counter("resolve_errors").value
        # state-memory accounting (reference: RESOLVER_STATE_MEMORY_LIMIT):
        # the footprint of the conflict-history state, and a pressure flag
        # when it exceeds the knob — a throttle/alert signal surfaced
        # through the same ratekeeper -> status-doc path as health
        sb = _engine_state_bytes(self.engine)
        if sb is not None:
            out["state_bytes"] = sb
            out["state_memory_pressure"] = (
                sb > SERVER_KNOBS.resolver_state_memory_limit)
        if self._service is not None and self._service.batcher is not None:
            out["target_batch_txns"] = self._service.target_batch_txns()
        # Unified telemetry fragment (docs/observability.md): engine perf
        # counters and the budget batcher's per-bucket EWMAs ride the same
        # poll, so they reach the master status fragment -> CC status doc ->
        # `tools/cli.py telemetry` without a second collection path.
        tel: Dict[str, dict] = {}
        perf = getattr(self.engine, "perf", None)
        if perf is None:
            # supervised engine: the device under the ResilientEngine
            perf = getattr(getattr(self.engine, "device", None), "perf", None)
        if perf is not None:
            tel["engine_perf"] = perf.as_dict()
        # compile & memory ledger (core/perfledger.py): per-compile
        # durations + flops/bytes/peak-HBM ride the same poll, joined by
        # `tools/cli.py perf` with the state-memory gauge below into one
        # memory view
        ledger = getattr(self.engine, "perf_ledger", None)
        if ledger is None:
            ledger = getattr(getattr(self.engine, "device", None),
                             "perf_ledger", None)
        if ledger is not None:
            tel["perf_ledger"] = ledger.snapshot()
        if sb is not None:
            # mirrored into the telemetry fragment so `cli perf` renders
            # the whole memory story from one status-doc subtree
            tel["state_bytes"] = sb
            tel["state_memory_pressure"] = out["state_memory_pressure"]
        if self._service is not None and self._service.batcher is not None:
            tel["batcher"] = self._service.batcher.as_dict()
        flight = getattr(self.engine, "flight", None)
        if flight is not None:
            tel["flight_recorder_entries"] = len(flight)
        # cluster watchdog (core/watchdog.py): evaluate-on-sync, then ride
        # the health poll -> ratekeeper -> master status -> CC status doc
        # -> `tools/cli.py alerts|incidents`. The firing burn-rate bit is
        # top-level like `degraded`: the ratekeeper consumes it as a rate
        # clamp without digging through the telemetry fragment.
        wd = telemetry.hub().watchdog
        if wd is not None:
            telemetry.hub().sync()
            tel["watchdog"] = wd.snapshot()
            out["burn_alert_firing"] = tel["watchdog"]["burn_firing"]
        # keyspace heat & occupancy (core/heatmap.py): hot ranges, table
        # headroom and suggested split points ride the same poll ->
        # ratekeeper -> CC status doc -> `tools/cli.py heat`
        heat_fn = getattr(self.engine, "heat_snapshot", None)
        if heat_fn is not None:
            heat = heat_fn()
            if heat is not None:
                tel["heat"] = heat
        # conflict-aware admission (pipeline/scheduler.py): predictor
        # scores, lane occupancy and pre-abort counters ride the same
        # poll -> ratekeeper -> CC status doc -> `tools/cli.py sched`
        cs = getattr(self._service, "conflict_sched", None) \
            if self._service is not None else None
        if cs is not None and cs.enabled:
            tel["sched"] = cs.snapshot()
        if tel:
            out["telemetry"] = tel
        return out

    def _sample_rows(self, transactions) -> None:
        rng = self._sample_rng
        for txn in transactions:
            for rng_list in (txn.read_conflict_ranges, txn.write_conflict_ranges):
                self._rows_since_poll += len(rng_list)
                self._rows_total += len(rng_list)
                for r in rng_list:
                    # reservoir sampling keyed by the running row count
                    if len(self._key_sample) < KEY_SAMPLE_SIZE:
                        self._key_sample.append(r.begin)
                    elif rng.random_int(0, self._rows_total) < KEY_SAMPLE_SIZE:
                        self._key_sample[rng.random_int(0, KEY_SAMPLE_SIZE)] = r.begin

    async def resolution_metrics(self, _req) -> dict:
        out = {"rows": self._rows_since_poll, "sample": list(self._key_sample)}
        # window-scoped: the split chooser must see the CURRENT key
        # distribution, not a lifetime-weighted one (a long uniform phase
        # would otherwise drown the hot range that triggered rebalancing)
        self._rows_since_poll = 0
        self._rows_total = 0
        self._key_sample = []
        return out

    async def resolve_batch(self, req: ResolveTransactionBatchRequest) -> ResolveTransactionBatchReply:
        """reference: resolveBatch, Resolver.actor.cpp:71-260."""
        # span anchor: queue wait = arrival -> the batch holds the version
        # chain (serial) or a service window slot (pipelined)
        t_enter = span_now() if g_spans.enabled else 0.0
        if req.version <= self.version.get():
            # Already resolved (proxy retry): replay the recorded verdicts.
            return await self._replay(req.version)
        await self.version.when_at_least(req.prev_version)
        if req.version <= self.version.get():
            # A duplicate delivery resolved this version while we waited.
            return await self._replay(req.version)
        if buggify.buggify():
            # slow resolve: batches queue up behind the version chain, so
            # proxies see deep pipelining + retry races
            from ..sim.loop import delay
            await delay(0.05, TaskPriority.PROXY_COMMIT)
            if req.version <= self.version.get():
                return await self._replay(req.version)
        window = MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        if buggify.buggify():
            # tight replay/conflict window: drives the too-old and
            # replay-window-GC'd paths that normally need huge lag
            window = window // 100
        new_oldest = max(0, req.version - window)
        inflight = self._inflight.get(req.version)
        if inflight is not None:
            # A duplicate delivery of a version still in dispatch (possible
            # once the engine awaits: pipeline slots, watchdogs, failover)
            # waits for the first delivery's outcome — checked BEFORE
            # sampling, so retried batches don't bias the split-key
            # reservoir twice.
            return await inflight.future
        transactions = req.transactions
        prepended = False
        if (getattr(req, "routing_version", 0)
                and req.version >= req.routing_version
                and req.routing_version > self._flip_seen):
            # Live rebalance handoff (bounce-free resolutionBalancing): this
            # is the first chained batch at or past the flip. Seed a
            # synthetic whole-span write over the ranges we GAINED: reads
            # with pre-flip snapshots conflict conservatively (we lack the
            # donor's history for them — exactly the reference's
            # "insufficient history => abort" rule), and everything with a
            # post-flip snapshot is checked exactly against the complete
            # history accumulated here from the flip on.
            self._flip_seen = req.routing_version
            gained = gained_ranges(tuple(req.routing_old_splits),
                                   tuple(req.routing_splits), self.index)
            if gained:
                synth = CommitTransaction(
                    read_snapshot=req.version,
                    write_conflict_ranges=[KeyRange(b, e) for b, e in gained],
                )
                transactions = [synth] + list(req.transactions)
                prepended = True
        self._sample_rows(req.transactions)

        if self._service is None:
            # Serial path: one batch at a time, the chain advances when the
            # batch is fully resolved. Once the engine can await (watchdog,
            # retries, failover — fault/resilient.py), duplicates of the
            # in-flight version are caught by the _inflight check above
            # (nothing awaits between it and the registration here).
            p = Promise()
            self._inflight[req.version] = p
            if g_spans.enabled:
                span_event("resolver.queue_wait", req.version,
                           t_enter, span_now(),
                           parent="proxy.resolve_rpc")
            try:
                verdicts = await self._engine_resolve(
                    transactions, req.version, new_oldest)
            except Exception as e:
                # Typed wrapping (the serial analog of the pipelined
                # except below): an engine/device fault must reach the
                # proxy as an FDBError it absorbs as commit_unknown_result
                # + chain repair, never an untyped exception that kills
                # the resolver actor mid-chain.
                self.stats.add("resolve_errors")
                self._inflight.pop(req.version, None)
                if not p.is_set:
                    p.send_error(error.please_reboot(
                        f"resolve {req.version} failed in engine"))
                if isinstance(e, error.FDBError):
                    raise
                raise error.please_reboot(
                    f"resolve {req.version} failed in engine: {e}") from e
            except BaseException:
                # cancellation (role killed): waiters get the honest answer
                self._inflight.pop(req.version, None)
                if not p.is_set:
                    p.send_error(error.please_reboot(
                        f"resolve {req.version} cancelled"))
                raise
            reply = self._finish(req.version, verdicts, prepended,
                                 new_oldest, transactions)
            self._inflight.pop(req.version, None)
            p.send(reply)
            return reply

        # Pipelined path: acquire a window slot, ADVANCE THE CHAIN AT
        # ACCEPT so the next batch enters its pack stage while this one is
        # still on the device (multi-batch in flight), and resolve through
        # the service — which runs engine.resolve strictly in commit-version
        # order, so abort sets are bit-identical to the serial path.
        await self._service.acquire()
        if req.version <= self.version.get():
            # A duplicate delivery accepted this version while we waited
            # for a slot; hand the slot back and follow the replay path.
            self._service.release()
            return await self._replay(req.version)
        p = Promise()
        self._inflight[req.version] = p
        self.version.set(req.version)
        if g_spans.enabled:
            span_event("resolver.queue_wait", req.version, t_enter,
                       span_now(), parent="proxy.resolve_rpc")
        try:
            verdicts = await self._service.resolve(
                transactions, req.version, new_oldest)
        except BaseException as e:
            self._inflight.pop(req.version, None)
            if not p.is_set:
                # duplicates waiting on this version get the honest answer:
                # the batch died in service; the proxy absorbs it as
                # commit_unknown_result + chain repair
                p.send_error(error.please_reboot(
                    f"resolve {req.version} failed in pipeline"))
            if isinstance(e, Exception):
                self.stats.add("resolve_errors")
                if not isinstance(e, error.FDBError):
                    # typed wrapping: an untyped engine exception would
                    # escape the handler and crash the whole run loop
                    raise error.please_reboot(
                        f"resolve {req.version} failed in pipeline: {e}") from e
            raise
        reply = self._finish(req.version, verdicts, prepended, new_oldest,
                             transactions, advance_chain=False)
        self._inflight.pop(req.version, None)
        p.send(reply)
        return reply

    async def _engine_resolve(self, transactions, version: Version,
                              new_oldest: Version):
        """Dispatch one batch to the conflict engine, awaiting engines whose
        resolve is a coroutine (fault/resilient.py's supervisor). Device
        faults under sim come from the supervisor's engine-boundary buggify
        sites (every dynamic spec wraps engines by default) — not here,
        where a raw-engine fault would need the proxy's retry machinery to
        absorb (direct resolver harnesses have none)."""
        t0 = span_now() if g_spans.enabled else 0.0
        r = self.engine.resolve(transactions, version, new_oldest)
        if hasattr(r, "__await__"):
            r = await r
        if g_spans.enabled:
            # serial path: no service stages, so the whole engine dispatch
            # is the device segment (pack rides inside it in zero vtime)
            span_event("resolver.device_dispatch", version, t0, span_now(),
                       txns=len(transactions),
                       parent="resolver.queue_wait")
        return r

    def _finish(self, version: Version, verdicts, prepended: bool,
                new_oldest: Version, transactions=None,
                advance_chain: bool = True) -> ResolveTransactionBatchReply:
        from ..core.types import TransactionCommitResult

        if transactions is not None and blackbox.enabled():
            # durable black-box record of the batch AS RESOLVED (synthetic
            # handoff writes included — differential replay re-resolves
            # exactly what the engine saw; core/blackbox.py)
            blackbox.record_batch(
                transactions, version, new_oldest, verdicts,
                shard=self.index,
                engine=getattr(self.engine, "name",
                               type(self.engine).__name__),
                proc=self.proc.address)
        if prepended:
            verdicts = verdicts[1:]   # the synthetic is ours, not a txn
        reply = ResolveTransactionBatchReply(committed=[int(v) for v in verdicts])
        self._recent[version] = reply
        # GC the replay window along with the conflict window (completions
        # are version-ordered even when pipelined, so this stays monotone).
        for v in [v for v in self._recent if v < new_oldest]:
            del self._recent[v]
        if advance_chain:
            self.version.set(version)
        self.stats.add("batches_resolved")
        self.stats.add("txns_in", len(reply.committed))
        for v in reply.committed:
            if v == int(TransactionCommitResult.COMMITTED):
                self.stats.add("txns_committed")
            elif v == int(TransactionCommitResult.TOO_OLD):
                self.stats.add("txns_too_old")
            else:
                self.stats.add("txns_conflicted")
        return reply

    async def _replay(self, version: Version) -> ResolveTransactionBatchReply:
        """A sufficiently delayed duplicate may ask for a version already
        GC'd from the replay window; that is a typed error the proxy's
        commit_unknown_result path absorbs, never a process crash. A
        version still in the pipeline's in-flight window answers with the
        in-flight result once it completes."""
        cached = self._recent.get(version)
        if cached is not None:
            return cached
        inflight = self._inflight.get(version)
        if inflight is not None:
            return await inflight.future
        raise error.please_reboot(f"resolve replay window GC'd version {version}")
