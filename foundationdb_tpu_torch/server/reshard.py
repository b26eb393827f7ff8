"""Online resolver resharding: the elastic resolution tier.

Port of ``foundationdb_tpu/server/reshard.py``: the same routing, two-phase
sweep, handoff protocol, spans, journal records and hub registrations.

ROADMAP item 4, the first change that makes the cluster ADAPT rather
than merely observe and throttle. Two pieces:

  * `ElasticResolverGroup` — a live group of supervised conflict engines
    (fault/resilient.py) partitioned by an epoched key-shard map
    (core/keyshard.EpochedKeyShardMap). Every batch routes by the epoch
    its commit version selects, so a flip at version F is atomic: batches
    below F resolve under the old partition, batches at or above F under
    the new one, and a transaction straddling the flip resolves under
    exactly the epoch its batch version picks — never both. Cross-shard
    batches run the same two-phase structure as the mesh kernel
    (parallel/sharding.py): local history detection per shard, ONE global
    earlier-in-batch-wins sweep on the host (the abort-set exchange), and
    write application of globally committed transactions only — so
    combined verdicts are bit-identical to a single serial oracle over
    the same stream, and no shard's table is ever polluted by a
    transaction another shard aborted.

  * `ReshardController` — the control loop that consumes the group's
    measured keyspace heat (concentration + equal-load split points,
    core/heatmap.py) and the watchdog's burn signal, and executes
    split / merge / move of key ranges on the live cluster: warm a
    recipient engine (pre-warmed spare or fresh), PRE-COPY the donor's
    coalesced committed-write history for the moving range while the
    donor keeps serving (fault/handoff.py), then freeze the range,
    transfer the residual delta, flip the epoch and unfreeze — the
    freeze -> cutover interval is the only per-range blackout, bounded
    by `reshard_blackout_budget_ms` and asserted per executed reshard.

Everything here is host-side: device engines arrive through
the injected `engine_factory`, the same stack production nodes run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import blackbox, error, telemetry
from ..core.heatmap import (
    LANE_CONFLICTS,
    LANE_WRITES,
    KeyRangeHeatAggregator,
    _fmt_key,
)
from ..core.keyshard import EpochedKeyShardMap, KeyShardMap
from ..core.knobs import SERVER_KNOBS
from ..core.trace import g_spans, span_event, span_now
from ..core.types import (
    CommitTransaction,
    Key,
    KeyRange,
    TransactionCommitResult,
    Version,
)
from ..fault import handoff
from ..sim.loop import Promise, TaskPriority, current_scheduler, delay

#: span segments the reshard protocol emits (`reshard.<segment>` — the
#: fdbtpu-lint span-registry rule checks reshard.* sites against this
#: tuple, like commit-path sites against ATTRIBUTION_SEGMENTS). These are
#: protocol-arc segments on their own timeline, not members of the commit
#: waterfall's telescoping sum.
RESHARD_SEGMENTS = (
    "warm",       # recipient engine build + ladder warmup (outside blackout)
    "precopy",    # unfrozen coalesced history pre-copy rounds
    "transfer",   # frozen residual-delta replay (inside the blackout)
    "blackout",   # freeze -> cutover: the only per-range unavailability
    "cutover",    # epoch install + unfreeze
)

#: pre-copy convergence: stop iterating once the residual delta is this
#: small (the frozen transfer then replays at most this many batches),
#: or after this many rounds regardless
PRECOPY_DELTA_TARGET = 8
PRECOPY_MAX_ROUNDS = 3

#: bounded duplicate-delivery verdict cache (versions -> verdicts)
RECENT_VERDICTS = 512

_COMMITTED = int(TransactionCommitResult.COMMITTED)
_TOO_OLD = int(TransactionCommitResult.TOO_OLD)
_CONFLICT = int(TransactionCommitResult.CONFLICT)


def _overlaps(a_begin: Key, a_end: Key, b_begin: Key, b_end: Key) -> bool:
    return a_begin < b_end and b_begin < a_end


@dataclass
class ShardSlot:
    """One engine's seat in the group. Slots outlive epochs: a donor
    retired by a merge cools down until recycled as a spare (its compiled
    programs survive clear(), so recycling never recompiles)."""

    sid: int
    inner: object
    injector: object
    engine: object            # the ResilientEngine
    batcher: Optional[object] = None


class ElasticResolverGroup:
    """A live, repartitionable group of supervised resolver engines."""

    name = "elastic"

    def __init__(self, engine_factory: Callable,
                 make_batcher: Optional[Callable] = None):
        #: () -> (inner, injector, supervised ResilientEngine) — journal
        #: recording is the factory's choice; the group replays whatever
        #: journals its slot engines kept (parity_check)
        self.engine_factory = engine_factory
        self._make_batcher = make_batcher
        self.slots: Dict[int, ShardSlot] = {}
        self._next_sid = 0
        self.spares: List[int] = []
        self.cooling: List[int] = []
        first = self.new_slot()
        self.emap = EpochedKeyShardMap(KeyShardMap([]))
        #: epoch id -> slot id per span of that epoch's map
        self._assign: Dict[int, List[int]] = {0: [first.sid]}
        #: group-level host-fed heat (core/heatmap.py observe_batch): the
        #: controller's split-planning input, engine-mode agnostic — the
        #: per-engine device histograms keep feeding telemetry separately
        self.heat = KeyRangeHeatAggregator(
            key_words=4, capacity=0, buckets=0,
            decay=float(getattr(SERVER_KNOBS, "resolver_heat_decay", 0.98)))
        telemetry.hub().register_heat(self.heat, "elastic")
        self._oldest: Version = 0
        self.last_version: Version = 0
        #: duplicate-delivery guard: a version resolved once answers from
        #: this cache forever after (bounded), and a version still in
        #: dispatch hands duplicates the in-flight future — across a
        #: handoff a duplicate must RESOLVE ONCE, never re-apply
        self._recent: Dict[Version, List[int]] = {}
        self._inflight: Dict[Version, Promise] = {}
        #: frozen ranges mid-handoff: (begin, end-or-None) spans a batch
        #: touching them waits out (the measured blackout)
        self._frozen: List[Tuple[Key, Optional[Key]]] = []
        self._busy: Optional[Promise] = None
        #: set by the attached ReshardController for the whole handoff arc
        self.reshard_in_flight = False
        self.extra_stats = {"fast_batches": 0, "two_phase_batches": 0,
                            "frozen_waits": 0}

    # -- slots ---------------------------------------------------------------
    def new_slot(self) -> ShardSlot:
        inner, injector, engine = self.engine_factory()
        slot = ShardSlot(self._next_sid, inner, injector, engine,
                         batcher=(self._make_batcher()
                                  if self._make_batcher else None))
        self._next_sid += 1
        self.slots[slot.sid] = slot
        return slot

    def prewarm_spares(self, n: int) -> None:
        """Build + warm standby engines BEFORE traffic so a reshard's
        recipient is ready without compiling on the serving path."""
        for _ in range(max(0, n)):
            slot = self.new_slot()
            fn = getattr(slot.engine, "warmup", None)
            if fn is not None:
                fn()
            self.spares.append(slot.sid)

    def take_recipient(self) -> Tuple[ShardSlot, bool]:
        """(slot, was_prewarmed): a spare if one is ready, else a
        recycled cooling donor (compiled programs persist across
        clear()), else a fresh build — the caller records the warm
        window in the last case. A cooling donor is recyclable only once
        NO retained epoch routes to it any more: the epoch chain is kept
        precisely so versions below the newest flip can still resolve,
        and clearing a slot an old epoch references would serve those
        straddlers an emptied conflict table."""
        if self.spares:
            return self.slots[self.spares.pop(0)], True
        still_routed = {sid for sids in self._assign.values()
                        for sid in sids}
        for i, sid in enumerate(self.cooling):
            if sid in still_routed:
                continue
            slot = self.slots[self.cooling.pop(i)]
            slot.engine.clear(0)
            # the journal restarts with the table: parity_check replays
            # each journal through ONE fresh oracle, so pre-clear batches
            # left in it would replay writes the cleared engine no longer
            # holds and report false mismatches
            if slot.engine.journal is not None:
                slot.engine.journal.clear()
            return slot, True
        return self.new_slot(), False

    def retire_slot(self, sid: int) -> None:
        self.cooling.append(sid)

    def active_sids(self) -> List[int]:
        return list(self._assign[self.emap.epoch])

    # -- engine surface (what ChaosCommitServer / resolvers consume) ---------
    @property
    def degraded(self) -> bool:
        return any(self.slots[s].engine.degraded for s in self.active_sids())

    @property
    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = dict(self.extra_stats)
        for slot in self.slots.values():
            for k, v in slot.engine.stats.items():
                out[k] = out.get(k, 0) + int(v)
        out["shards"] = len(self.active_sids())
        return out

    @property
    def loop_stats(self) -> Optional[Dict[str, float]]:
        """Aggregated device-loop sync accounting across every slot that
        has one (device_loop engine mode) — blocking_syncs must stay 0
        group-wide; None for step/oracle modes."""
        agg: Optional[Dict[str, float]] = None
        for slot in self.slots.values():
            st = getattr(slot.inner, "loop_stats", None)
            if st is None:
                continue
            if agg is None:
                agg = {}
            for k, v in st.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def device_view(self) -> Optional[List[dict]]:
        """Per-slot device placement for mesh-backed slots — each active
        slot's mesh engine reports its shard -> device rows (device id,
        table bytes, last measured collective ms) tagged with the slot id
        routing sends it traffic under. None when no slot is mesh-backed
        (single-chip engine modes): `cli shards` renders the epoch map
        alone, old reports stay readable."""
        out: List[dict] = []
        for sid in self.active_sids():
            fn = getattr(self.slots[sid].inner, "device_view", None)
            if fn is None:
                continue
            for row in fn():
                out.append({"sid": sid, **row})
        return out or None

    def health_stats(self) -> dict:
        sev = {"healthy": 0, "suspect": 1, "failed": 2, "probation": 3,
               "quarantined": 4}
        states = [self.slots[s].engine.state for s in self.active_sids()]
        worst = max(states, key=lambda s: sev.get(s, 0)) if states else "healthy"
        return {
            "state": worst,
            "degraded": self.degraded,
            "device": "elastic",
            "shards": len(self.active_sids()),
            "epoch": self.emap.epoch,
            "reshard_in_flight": self.reshard_in_flight,
            "per_shard": [{"sid": s, "state": self.slots[s].engine.state}
                          for s in self.active_sids()],
            **{k: v for k, v in self.stats.items()},
        }

    def heat_snapshot(self, top_n: int = 8, brief: bool = False) -> dict:
        snap = self.heat.snapshot(top_n=top_n, brief=brief)
        if not brief:
            snap["epoch"] = self.emap.epoch
            snap["shard_splits"] = [_fmt_key(k)
                                    for k in self.emap.current().begins[1:]]
        return snap

    def warmup(self) -> "ElasticResolverGroup":
        for sid in self.active_sids():
            fn = getattr(self.slots[sid].engine, "warmup", None)
            if fn is not None:
                fn()
        return self

    def clear(self, version: Version) -> None:
        for slot in self.slots.values():
            slot.engine.clear(version)
        self._recent.clear()

    def parity_check(self) -> Tuple[int, int]:
        """Replay EVERY slot engine's journal through its own clean CPU
        oracle (the per-engine contract of fault/resilient.py, summed):
        each shard's emitted abort sets — handoff adoption batches
        included — must be bit-identical to a fault-free engine's."""
        from ..ops.oracle import OracleConflictEngine

        checked = mismatches = 0
        for slot in self.slots.values():
            clean = OracleConflictEngine()
            for version, txns, new_oldest, verdicts in slot.engine.journal or []:
                want = clean.resolve(list(txns), version, new_oldest)
                checked += 1
                if [int(x) for x in want] != [int(x) for x in verdicts]:
                    mismatches += 1
        return checked, mismatches

    # -- freeze gate ---------------------------------------------------------
    def freeze(self, ranges: Sequence[Tuple[Key, Optional[Key]]]) -> None:
        self._frozen.extend(ranges)

    def unfreeze(self) -> None:
        self._frozen = []

    def _touches_frozen(self, transactions) -> bool:
        if not self._frozen:
            return False
        for txn in transactions:
            for rngs in (txn.read_conflict_ranges, txn.write_conflict_ranges):
                for r in rngs:
                    for fb, fe in self._frozen:
                        if r.begin >= r.end:
                            # empty range: a point probe at begin —
                            # conservative boundary-inclusive test
                            if r.begin >= fb and (fe is None or r.begin <= fe):
                                return True
                        # fe None is a TRUE +inf (the last span), so only
                        # the lower bound constrains the overlap test
                        elif (fe is None or r.begin < fe) and fb < r.end:
                            return True
        return False

    async def quiesce(self) -> None:
        """Wait out the batch in flight at call time (the controller
        freezes first, so every later batch touching the moving ranges
        blocks at the gate; untouched batches keep flowing)."""
        busy = self._busy
        if busy is not None:
            await busy.future

    # -- resolution ----------------------------------------------------------
    async def resolve(self, transactions, now_v: Version,
                      new_oldest: Version):
        cached = self._recent.get(now_v)
        if cached is not None:
            return list(cached)
        inflight = self._inflight.get(now_v)
        if inflight is not None:
            return await inflight.future
        p = Promise()
        self._inflight[now_v] = p
        try:
            verdicts = await self._resolve_impl(transactions, now_v,
                                                new_oldest)
        except BaseException as e:
            self._inflight.pop(now_v, None)
            if not p.is_set:
                p.send_error(e if isinstance(e, error.FDBError)
                             else error.device_fault(
                                 f"elastic resolve {now_v} failed: {e}"))
            raise
        self._recent[now_v] = list(verdicts)
        while len(self._recent) > RECENT_VERDICTS:
            self._recent.pop(next(iter(self._recent)))
        self._inflight.pop(now_v, None)
        p.send(list(verdicts))
        return verdicts

    async def _resolve_impl(self, transactions, now_v: Version,
                            new_oldest: Version):
        # freeze gate: a batch touching a mid-handoff range waits for the
        # cutover (the measured per-range blackout); untouched batches
        # pass the gate. NOTE the per-range guarantee is at THIS
        # interface: a version-ordered serial caller (the commit
        # batcher) cannot overtake a parked batch, so downstream of one
        # the whole pipeline stalls for the blackout — which is exactly
        # why the blackout carries a tight budget and its windows are
        # excluded from the p99 population (docs/elasticity.md)
        if self._touches_frozen(transactions):
            self.extra_stats["frozen_waits"] += 1
            while self._touches_frozen(transactions):
                await delay(0.002, TaskPriority.PROXY_RESOLVER_REPLY)
        self._busy = Promise()
        try:
            _e, _fv, m = self.emap.entry_for_version(now_v)
            sids = self._assign[_e]
            n = len(transactions)
            gate = self._oldest
            too_old = [bool(t.read_conflict_ranges) and t.read_snapshot < gate
                       for t in transactions]
            touched: List[List[int]] = []
            for t, txn in enumerate(transactions):
                sh: set = set()
                if not too_old[t]:
                    for r in txn.read_conflict_ranges:
                        if r.begin >= r.end:
                            sh.add(m.shard_of_point_below(r.begin))
                        else:
                            sh.update(s for s, _b, _e2 in
                                      m.shards_of_range(r.begin, r.end))
                    for r in txn.write_conflict_ranges:
                        if r.begin < r.end:
                            sh.update(s for s, _b, _e2 in
                                      m.shards_of_range(r.begin, r.end))
                touched.append(sorted(sh))
            if all(len(s) <= 1 for s in touched):
                verdicts = await self._resolve_fast(
                    transactions, now_v, new_oldest, m, sids, too_old, touched)
            else:
                verdicts = await self._resolve_two_phase(
                    transactions, now_v, new_oldest, m, sids, too_old)
            if new_oldest > self._oldest:
                self._oldest = new_oldest
                self.emap.gc(self._oldest)
                retained = {e for e, _fv, _m in self.emap.epochs}
                for e in [e for e in self._assign if e not in retained]:
                    del self._assign[e]
            self.last_version = max(self.last_version, now_v)
            self.heat.observe_batch(transactions, verdicts, version=now_v)
            if blackbox.enabled():
                # the group is the resolution tier's top level here: ONE
                # batch record per version (slot engines underneath never
                # record), stamped with the epoch that routed it — the
                # differential-replay unit of core/blackbox.py
                shards_touched = sorted({s for sh in touched for s in sh})
                blackbox.record_batch(
                    transactions, now_v, new_oldest, verdicts,
                    epoch=_e,
                    shard=(shards_touched[0]
                           if len(shards_touched) == 1 else -1),
                    engine="elastic",
                    served_by=("fast" if all(len(s) <= 1 for s in touched)
                               else "two_phase"),
                    witness=self.heat.attribution_for(now_v))
            return verdicts
        finally:
            busy, self._busy = self._busy, None
            if busy is not None and not busy.is_set:
                busy.send(None)

    async def _resolve_fast(self, transactions, now_v, new_oldest, m, sids,
                            too_old, touched):
        """Every transaction's ranges live inside one shard: dispatch each
        shard its whole sub-batch in one pass. Disjoint key families never
        interact in the serial oracle, so per-shard resolution composes to
        exactly the serial verdicts."""
        self.extra_stats["fast_batches"] += 1
        per_shard: Dict[int, List[int]] = {}
        for t, sh in enumerate(touched):
            if too_old[t] or not sh:
                continue
            per_shard.setdefault(sh[0], []).append(t)
        verdicts = [_TOO_OLD if too_old[t] else _COMMITTED
                    for t in range(len(transactions))]
        results = await self._dispatch_shards(
            {s: [transactions[t] for t in per_shard[s]]
             for s in per_shard}, sids, now_v, new_oldest)
        for s, got in results.items():
            for t, vd in zip(per_shard[s], got):
                verdicts[t] = int(vd)
        return verdicts

    async def _resolve_two_phase(self, transactions, now_v, new_oldest, m,
                                 sids, too_old):
        """Cross-shard batch: the host-side analog of the mesh kernel's
        exchange (parallel/sharding.py). Phase 1 asks every shard for
        history hits on its CLIPPED read views (read-only — applies
        nothing); the global earlier-in-batch-wins sweep then runs ONCE
        on the full unclipped ranges (the oracle's intra-batch phase,
        verbatim); phase 2 applies only globally committed transactions'
        clipped writes. Verdicts are bit-identical to one serial oracle
        over the same stream, and no shard table ever contains a write of
        a transaction another shard aborted."""
        self.extra_stats["two_phase_batches"] += 1
        n = len(transactions)
        conflict = [False] * n
        # phase 1: per-shard read-only clipped views
        views: Dict[int, List[Tuple[int, CommitTransaction]]] = {}
        for t, txn in enumerate(transactions):
            if too_old[t] or not txn.read_conflict_ranges:
                continue
            per: Dict[int, CommitTransaction] = {}

            def view(s: int) -> CommitTransaction:
                if s not in per:
                    per[s] = CommitTransaction(
                        read_snapshot=txn.read_snapshot)
                return per[s]

            for r in txn.read_conflict_ranges:
                if r.begin >= r.end:
                    view(m.shard_of_point_below(r.begin)) \
                        .read_conflict_ranges.append(r)
                else:
                    for s, cb, ce in m.shards_of_range(r.begin, r.end):
                        view(s).read_conflict_ranges.append(KeyRange(cb, ce))
            for s, vw in per.items():
                views.setdefault(s, []).append((t, vw))
        results = await self._dispatch_shards(
            {s: [vw for _t, vw in views[s]] for s in views},
            sids, now_v, new_oldest)
        for s, got in results.items():
            for (t, _vw), vd in zip(views[s], got):
                if int(vd) != _COMMITTED:
                    conflict[t] = True
        # global intra-batch sweep, strictly in submission order
        written: List[KeyRange] = []
        for t, txn in enumerate(transactions):
            if too_old[t] or conflict[t]:
                continue
            hit = False
            for r in txn.read_conflict_ranges:
                if r.begin < r.end and any(
                        _overlaps(r.begin, r.end, w.begin, w.end)
                        for w in written):
                    hit = True
                    break
            if hit:
                conflict[t] = True
                continue
            for w in txn.write_conflict_ranges:
                if w.begin < w.end:
                    written.append(w)
        # phase 2: apply globally committed writes, clipped per shard
        wviews: Dict[int, List[CommitTransaction]] = {}
        for t, txn in enumerate(transactions):
            if too_old[t] or conflict[t]:
                continue
            per_w: Dict[int, CommitTransaction] = {}
            for r in txn.write_conflict_ranges:
                if r.begin >= r.end:
                    continue
                for s, cb, ce in m.shards_of_range(r.begin, r.end):
                    vw = per_w.get(s)
                    if vw is None:
                        vw = per_w[s] = CommitTransaction(
                            read_snapshot=now_v)
                    vw.write_conflict_ranges.append(KeyRange(cb, ce))
            for s, vw in per_w.items():
                wviews.setdefault(s, []).append(vw)
        await self._dispatch_shards(wviews, sids, now_v, new_oldest)
        return [
            _TOO_OLD if too_old[t] else
            (_CONFLICT if conflict[t] else _COMMITTED)
            for t in range(n)
        ]

    async def _dispatch_shards(self, sub_by_shard: Dict[int, list], sids,
                               now_v, new_oldest) -> Dict[int, list]:
        """Dispatch every shard's sub-batch CONCURRENTLY and join in
        sorted-shard order (deterministic assembly; batch latency is the
        max of the shard resolves, not their sum — the overlap sharding
        exists for). Every task is awaited even after a failure so no
        dispatch is abandoned mid-flight; the first error propagates."""
        shards = sorted(sub_by_shard)
        if len(shards) == 1:
            s = shards[0]
            return {s: await self._slot_resolve(
                sids[s], self.slots[sids[s]].engine, sub_by_shard[s],
                now_v, new_oldest)}
        sched = current_scheduler()
        tasks = [(s, sched.spawn(
            self._slot_resolve(sids[s], self.slots[sids[s]].engine,
                               sub_by_shard[s], now_v, new_oldest),
            TaskPriority.PROXY_RESOLVER_REPLY,
            name=f"shardResolve.{s}")) for s in shards]
        results: Dict[int, list] = {}
        first_err: Optional[BaseException] = None
        for s, task in tasks:
            try:
                results[s] = await task
            except BaseException as e:   # noqa: BLE001 — collected below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    async def _slot_resolve(self, sid: int, eng, sub, now_v, new_oldest):
        t0 = span_now()
        got = await eng.resolve(sub, now_v, new_oldest)
        slot = self.slots[sid]
        if slot.batcher is not None and sub:
            slot.batcher.observe(slot.batcher.bucket_of(len(sub)),
                                 (span_now() - t0) * 1e3)
        return got


# -- the control loop ---------------------------------------------------------

@dataclass
class ReshardOp:
    """One executed (or in-flight) reshard, the report/CLI record."""

    id: int
    kind: str                      # split | merge | move
    begin: str                     # moving range, formatted
    end: Optional[str]
    donor_sids: List[int]
    recipient_sid: int = -1
    state: str = "planned"         # planned -> warm -> precopy -> frozen
    #                               -> done | stalled | aborted
    t_start: float = 0.0
    t_freeze: float = 0.0
    t_cutover: float = 0.0
    flip_version: int = 0
    epoch: int = 0
    blackout_ms: float = 0.0
    precopied: int = 0
    delta: int = 0
    prewarmed: bool = False
    ewmas_migrated: int = 0
    error: Optional[str] = None

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ReshardController:
    """Heat-driven split/merge/move of live resolver key ranges."""

    def __init__(self, group: ElasticResolverGroup,
                 now_fn: Callable[[], float] = span_now,
                 min_heat_batches: int = 20,
                 on_complete: Optional[Callable] = None):
        self.group = group
        self.now_fn = now_fn
        self.min_heat_batches = min_heat_batches
        self.on_complete = on_complete
        self.ops: List[ReshardOp] = []
        self.current: Optional[ReshardOp] = None
        self.executed = 0
        self.stalled = 0
        self.blackout_ms_max = 0.0
        self.blackout_over_budget = 0
        #: {kind, t0, t1} wall-clock records of blackout + inline-warm
        #: intervals — the campaign's SLO exclusion/correlation windows
        self.windows: List[dict] = []
        self._next_id = 1
        self._last_done = 0.0
        self._task = None
        telemetry.hub().register_reshard(self, "controller")

    # -- telemetry read model ------------------------------------------------
    def in_flight(self) -> bool:
        return self.current is not None

    def in_flight_age_s(self) -> float:
        if self.current is None:
            return 0.0
        return max(0.0, self.now_fn() - self.current.t_start)

    def in_flight_detail(self) -> Optional[str]:
        """What a stalled-reshard incident should lead with: the frozen
        range and the donor engine's health state."""
        op = self.current
        if op is None:
            return None
        donors = ", ".join(
            f"r{sid} state={self.group.slots[sid].engine.state}"
            for sid in op.donor_sids if sid in self.group.slots)
        end = op.end if op.end is not None else "+inf"
        return (f"reshard of [{op.begin},{end}) {op.state} · donor {donors}")

    def snapshot(self) -> dict:
        return {
            "executed": self.executed,
            "stalled": self.stalled,
            "in_flight": (self.current.as_dict()
                          if self.current is not None else None),
            "blackout_ms_max": round(self.blackout_ms_max, 3),
            "blackout_budget_ms": float(
                SERVER_KNOBS.reshard_blackout_budget_ms),
            "blackout_over_budget": self.blackout_over_budget,
            "epoch": self.group.emap.epoch,
            "shard_map": self.group.emap.as_dict(),
            "device_view": self.group.device_view(),
            "ops": [op.as_dict() for op in self.ops],
            "group": {k: v for k, v in self.group.extra_stats.items()},
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self, sched) -> None:
        self._task = sched.spawn(self._run(), TaskPriority.RATEKEEPER,
                                 name="reshardController")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await delay(float(SERVER_KNOBS.reshard_eval_interval_s),
                        TaskPriority.RATEKEEPER)
            op = self.current
            if op is not None:
                if (op.state == "stalled" and self.in_flight_age_s()
                        > 2 * float(SERVER_KNOBS.reshard_stall_s)):
                    # the stalled alert has fired and held; abandon the op
                    # so the cluster returns to a steady (old-epoch) state
                    op.state = "aborted"
                    self.group.unfreeze()
                    self.group.reshard_in_flight = False
                    self.current = None
                continue
            plan = self.plan()
            if plan is not None:
                await self.execute(plan)

    # -- planning ------------------------------------------------------------
    def _min_interval_s(self) -> float:
        base = float(SERVER_KNOBS.reshard_min_interval_s)
        wd = telemetry.hub().watchdog
        if wd is not None and wd.burn_firing():
            # the SLO budget is burning NOW: a partition that no longer
            # tracks the load is a likely cause — react at double speed
            return base / 2
        return base

    def plan(self) -> Optional[dict]:
        g = self.group
        if g.heat.batches < self.min_heat_batches:
            return None
        if self.now_fn() - self._last_done < self._min_interval_s():
            return None
        m = g.emap.current()
        splits = list(m.begins[1:])
        shares = g.heat.split_balance(len(splits) + 1, splits)
        if not shares:
            return None
        max_shards = int(SERVER_KNOBS.reshard_max_shards)
        split_share = float(SERVER_KNOBS.reshard_split_share)
        merge_share = float(SERVER_KNOBS.reshard_merge_share)
        hot = max(range(len(shares)), key=lambda i: shares[i])
        if shares[hot] > split_share and len(shares) < max_shards:
            b = m.begins[hot]
            e = m.span_end(hot)
            k = g.heat.split_key_within(b, e)
            if k is not None:
                return {"kind": "split", "span": hot, "key": k}
        if len(shares) > 1:
            pairs = [(shares[i] + shares[i + 1], i)
                     for i in range(len(shares) - 1)]
            combined, i = min(pairs)
            if combined < merge_share:
                return {"kind": "merge", "span": i}
        if shares[hot] > split_share and len(shares) >= max_shards:
            # at the shard cap: MOVE load off the hottest span by shifting
            # its boundary toward a lighter neighbor
            nb = hot + 1 if hot + 1 < len(shares) else hot - 1
            if 0 <= nb < len(shares) and shares[nb] < merge_share:
                lo = m.begins[hot]
                hi = m.span_end(hot)
                k = g.heat.split_key_within(lo, hi)
                if k is not None:
                    return {"kind": "move", "span": hot, "neighbor": nb,
                            "key": k}
        return None

    # -- execution -----------------------------------------------------------
    async def execute(self, plan: dict) -> Optional[ReshardOp]:
        g = self.group
        m = g.emap.current()
        sids = g.active_sids()
        splits = list(m.begins[1:])
        kind = plan["kind"]
        s = plan["span"]
        if kind == "split":
            # new slot takes [key, span_end); donor keeps [begin, key)
            key = plan["key"]
            moving = [(sids[s], key, m.span_end(s))]
            new_splits = sorted(set(splits + [key]))
            new_sids_of = lambda rsid: (
                sids[: s + 1] + [rsid] + sids[s + 1:])
            retire: List[int] = []
            begin, end = key, m.span_end(s)
        elif kind == "merge":
            # fresh slot takes both spans; both donors retire
            moving = [(sids[s], m.begins[s], m.span_end(s)),
                      (sids[s + 1], m.begins[s + 1], m.span_end(s + 1))]
            new_splits = [k for k in splits if k != m.begins[s + 1]]
            new_sids_of = lambda rsid: (sids[:s] + [rsid] + sids[s + 2:])
            retire = [sids[s], sids[s + 1]]
            begin, end = m.begins[s], m.span_end(s + 1)
        else:   # move: neighbor absorbs [key, span_end(s)) (or the mirror)
            key = plan["key"]
            nb = plan["neighbor"]
            if nb > s:
                # recipient takes [key, end(nb)): donor's tail + neighbor
                moving = [(sids[s], key, m.span_end(s)),
                          (sids[nb], m.begins[nb], m.span_end(nb))]
                new_splits = sorted(set(
                    [k for k in splits if k != m.begins[nb]] + [key]))
                begin, end = key, m.span_end(nb)
            else:
                # recipient takes [begin(nb), key): neighbor + donor's head
                moving = [(sids[nb], m.begins[nb], m.span_end(nb)),
                          (sids[s], m.begins[s], key)]
                new_splits = sorted(set(
                    [k for k in splits if k != m.begins[s]] + [key]))
                begin, end = m.begins[nb], key
            new_sids_of = lambda rsid: [
                rsid if i == nb else sid for i, sid in enumerate(sids)]
            retire = [sids[nb]]
        op = ReshardOp(
            id=self._next_id, kind=kind, begin=_fmt_key(begin),
            end=_fmt_key(end) if end is not None else None,
            donor_sids=[sid for sid, _b, _e in moving],
            t_start=self.now_fn())
        self._next_id += 1
        self.ops.append(op)
        self.current = op
        g.reshard_in_flight = True
        spans_on = g_spans.enabled
        rid = f"reshard-{op.id}"
        recipient = None
        try:
            # WARM: recipient out of the spare/cooling pool, or inline
            # (recorded as a window — compiles on the serving path are an
            # incident, not steady state)
            op.state = "warm"
            t0 = self.now_fn()
            ts0 = span_now()
            recipient, prewarmed = g.take_recipient()
            op.recipient_sid, op.prewarmed = recipient.sid, prewarmed
            if not prewarmed:
                fn = getattr(recipient.engine, "warmup", None)
                if fn is not None:
                    fn()
                self.windows.append({"kind": "reshard_warm", "t0": t0,
                                     "t1": self.now_fn()})
            if spans_on:
                span_event("reshard.warm", rid, ts0, span_now(),
                           Proc="reshard", prewarmed=prewarmed)
            if blackbox.enabled():
                blackbox.record_reshard(op, "warm")
            # PRE-COPY: coalesced history while the donors keep serving
            op.state = "precopy"
            ts0 = span_now()
            marks = {sid: 0 for sid, _b, _e in moving}
            # tiered donors (docs/perf.md "Incremental history
            # maintenance") serve later rounds straight off their
            # un-merged device runs: seed the per-donor (nruns, merge
            # epoch) chain BEFORE the full shadow read so a batch
            # landing in between is re-fetched, never skipped
            run_marks: Dict[int, tuple] = {}
            for sid, _b, _e in moving:
                wm = handoff.run_watermarks(g.slots[sid].engine)
                if wm is not None and wm[1] is not None:
                    run_marks[sid] = wm
            entries = self._slice_all(moving, marks)
            entries = handoff.coalesce(entries, begin, end)
            for sid, _b, _e in moving:
                marks[sid] = handoff.last_shadow_version(
                    g.slots[sid].engine)
            op.precopied += await handoff.replay_slice(recipient.engine,
                                                       entries)
            for _round in range(PRECOPY_MAX_ROUNDS):
                # a round read off a tiered donor's runs advances its run
                # watermark; a round left for the frozen transfer must not,
                # or the transfer reads past the entries it has to replay
                # (the reference advances it and loses them: its recipient
                # misses committed writes of the moving range)
                chain = dict(run_marks)
                delta = self._slice_all(moving, marks, run_marks)
                if len(delta) <= PRECOPY_DELTA_TARGET:
                    run_marks.clear()
                    run_marks.update(chain)
                    break
                for sid, _b, _e in moving:
                    marks[sid] = handoff.last_shadow_version(
                        g.slots[sid].engine)
                op.precopied += await handoff.replay_slice(
                    recipient.engine, sorted(delta))
            # CATCH-UP (the port's; the reference freezes here): wait out
            # the batch in flight, then replay what the rounds left while
            # the donors still serve. The frozen transfer then holds only
            # what lands during this replay: on a loaded host each residual
            # batch is one eager resolve (~15-60 ms on a CPU), and the
            # rounds leave up to PRECOPY_DELTA_TARGET of them
            await g.quiesce()
            delta = self._slice_all(moving, marks, run_marks)
            if delta:
                for sid, _b, _e in moving:
                    marks[sid] = handoff.last_shadow_version(
                        g.slots[sid].engine)
                op.precopied += await handoff.replay_slice(
                    recipient.engine, sorted(delta))
            if spans_on:
                span_event("reshard.precopy", rid, ts0, span_now(),
                           Proc="reshard", batches=op.precopied)
            if blackbox.enabled():
                blackbox.record_reshard(op, "precopy")
            # FREEZE -> residual delta -> CUTOVER: the blackout. The port
            # waits out the batch in flight BEFORE freezing (the reference
            # freezes first): batches that touch the moving ranges keep
            # flowing while it lands, so the wait is no blackout
            await g.quiesce()
            op.state = "frozen"
            g.freeze([(b, e) for _sid, b, e in moving])
            op.t_freeze = self.now_fn()
            if blackbox.enabled():
                blackbox.record_reshard(op, "frozen")
            ts_freeze = span_now()
            await g.quiesce()
            delta = sorted(self._slice_all(moving, marks, run_marks))
            op.delta = await handoff.replay_slice(recipient.engine, delta)
            if spans_on:
                span_event("reshard.transfer", rid, ts_freeze, span_now(),
                           Proc="reshard", batches=op.delta)
            ts_cut = span_now()
            op.flip_version = g.last_version + 1
            new_map = KeyShardMap(new_splits)
            op.epoch = g.emap.flip(new_map, op.flip_version)
            g._assign[op.epoch] = new_sids_of(recipient.sid)
            g.unfreeze()
            op.t_cutover = self.now_fn()
            op.blackout_ms = (op.t_cutover - op.t_freeze) * 1e3
            if blackbox.enabled():
                # the epoch flip, with the new split keys: routing under
                # any version is reconstructible from the journal alone
                blackbox.record_reshard(
                    op, "flip", epoch=op.epoch,
                    flip_version=op.flip_version,
                    splits=[_fmt_key(k) for k in new_map.begins[1:]])
            if spans_on:
                span_event("reshard.cutover", op.flip_version, ts_cut,
                           span_now(), Proc="reshard", epoch=op.epoch)
                span_event("reshard.blackout", op.flip_version, ts_freeze,
                           span_now(), Proc="reshard", kind=kind,
                           begin=op.begin, end=op.end,
                           blackout_ms=round(op.blackout_ms, 3))
            # mid-flight adaptation: the donor's observed latency EWMAs
            # move with the range (no cold re-learn), donors cool for
            # recycling, admission rebalances via on_complete
            op.ewmas_migrated = sum(
                handoff.migrate_ewmas(g.slots[sid].batcher,
                                      recipient.batcher)
                for sid in op.donor_sids)
            for sid in retire:
                g.retire_slot(sid)
            op.state = "done"
            self.executed += 1
            self.blackout_ms_max = max(self.blackout_ms_max, op.blackout_ms)
            if op.blackout_ms > float(SERVER_KNOBS.reshard_blackout_budget_ms):
                self.blackout_over_budget += 1
            self.windows.append({"kind": "reshard", "t0": op.t_freeze,
                                 "t1": op.t_cutover})
            # the whole handoff arc (plan -> warm -> pre-copy -> cutover)
            # as a CORRELATION-ONLY window, the device-incident
            # failover->swap-back precedent: on CPU-emulated engines the
            # pre-copy/warm work shares the host with serving, so alerts
            # lit by that contention must correlate to the arc — but the
            # arc is NOT excluded from the p99 population (the service
            # keeps serving through it; only the blackout is planned
            # unavailability)
            self.windows.append({"kind": "reshard_arc", "t0": op.t_start,
                                 "t1": op.t_cutover})
            telemetry.hub().chaos_event("reshard_" + kind,
                                        begin=op.begin, end=op.end)
            self._last_done = self.now_fn()
            self.current = None
            g.reshard_in_flight = False
            if blackbox.enabled():
                blackbox.record_reshard(op, "done", epoch=op.epoch,
                                        flip_version=op.flip_version)
            if self.on_complete is not None:
                self.on_complete(op)
            return op
        except Exception as e:   # noqa: BLE001 — a stalled handoff must
            #                       surface as an alert, never crash serving
            op.state = "stalled"
            op.error = f"{type(e).__name__}: {e}"
            self.stalled += 1
            if blackbox.enabled():
                blackbox.record_reshard(op, "stalled")
            g.unfreeze()
            # the recipient never went live (op.epoch is only set at the
            # flip): cool it for recycling instead of leaking the warmed
            # engine — take_recipient clears any partially adopted
            # history on reuse
            if recipient is not None and op.epoch == 0:
                g.retire_slot(recipient.sid)
            if op.t_freeze > 0:
                # acks blocked at the freeze gate during the failed
                # handoff are planned-maintenance latency like a
                # completed blackout: record the interval so the
                # campaign excludes and correlates it
                self.windows.append({"kind": "reshard_aborted",
                                     "t0": op.t_freeze,
                                     "t1": self.now_fn()})
            return None

    def _slice_all(self, moving, marks,
                   run_marks=None) -> List[handoff.HistoryBatch]:
        """One pre-copy round's entries across the moving donors. With
        `run_marks` ({sid: (nruns vector, merge epoch)}), a tiered
        donor's round reads only the runs appended since its chain mark
        — O(delta) off the device image — falling back to the
        always-sufficient shadow when the donor can't serve the path or
        a compaction broke the chain (resync). Duplicate entries at or
        below a donor's version mark are filtered exactly like the
        shadow path filters them."""
        out: List[handoff.HistoryBatch] = []
        for sid, b, e in moving:
            eng = self.group.slots[sid].engine
            mv = marks.get(sid, 0)
            got = None
            if run_marks is not None and sid in run_marks:
                since, epoch = run_marks[sid]
                got = handoff.run_slice(eng, b, e, since_runs=since,
                                        since_epoch=epoch)
                if got is not None and got["resync"]:
                    got = None
            if got is None:
                if run_marks is not None and sid in run_marks:
                    # re-seed before the shadow read so the NEXT round
                    # can go incremental again
                    wm = handoff.run_watermarks(eng)
                    if wm is not None and wm[1] is not None:
                        run_marks[sid] = wm
                    else:
                        run_marks.pop(sid, None)
                out.extend(handoff.shadow_slice(eng, b, e, min_version=mv))
            else:
                run_marks[sid] = (got["watermarks"], got["epoch"])
                out.extend((v, w) for v, w in got["entries"] if v > mv)
        return out


def rebalance_admission(admission, heat: KeyRangeHeatAggregator,
                        sep: bytes = b"/", floor: float = 0.05) -> Dict[str, float]:
    """Recompute per-tenant admission weights from the post-reshard heat
    fractions: tenants whose key prefixes carry the measured load get the
    matching share of the published rate (server/ratekeeper.py
    TenantAdmission). Keys follow the workload convention
    `<tenant><sep><suffix>`; load is the write+conflict lane sum.

    Weights are normalized to MEAN 1.0, not sum 1.0: TenantAdmission
    gives tenants absent from the weight table a default weight of 1.0,
    so fractional weights would let any tenant the decayed/pruned heat
    no longer retains (a light uniform tenant can fall out of the
    bounded range map entirely) out-weigh every measured one. Tenants
    the admission layer has already seen but heat no longer measures
    keep the floor share instead of dropping to the default."""
    by_tenant: Dict[str, float] = {}
    total = 0.0
    for key, w in heat._w.items():
        name = key.split(sep, 1)[0].decode("latin-1")
        load = float(w[LANE_WRITES] + w[LANE_CONFLICTS])
        by_tenant[name] = by_tenant.get(name, 0.0) + load
        total += load
    if not by_tenant or total <= 0:
        return {}
    if admission is not None:
        for name in set(admission.admitted) | set(admission.rejected) \
                | set(admission.weights):
            by_tenant.setdefault(name, 0.0)
    fracs = {t: max(floor, load / total) for t, load in by_tenant.items()}
    mean = sum(fracs.values()) / len(fracs)
    weights = {t: f / mean for t, f in fracs.items()}
    if admission is not None:
        admission.weights = dict(weights)
    return weights
