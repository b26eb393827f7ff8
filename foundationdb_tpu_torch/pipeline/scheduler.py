"""Conflict-aware batch scheduling: predict, separate, serialize, pre-abort.

Port of ``foundationdb_tpu/pipeline/scheduler.py``: the same predictor,
lanes, separation rules, probes and counters, so the same pending window
yields the same schedule in both packages. A deterministic scheduler
between admission and the batcher that schedules AROUND predicted
conflicts instead of paying for them: it reads the heat aggregator's
first-witness stream (core/heatmap.py `drain_witnesses()`) and the
verdicts of every resolved batch.

Four mechanisms, all knob-gated (`resolver_sched*`, docs/scheduling.md):

  * **predictor** — a decayed per-key-range conflict score fed by the heat
    aggregator's consumable first-witness stream (`drain_witnesses()`) and
    by the verdict feedback of every resolved batch, plus a bounded
    last-committed-write version per hot range. A transaction reading a
    hot range whose last write is newer than its read snapshot is
    predicted DOOMED — under strict-serializable validation that verdict
    is already decided, the device dispatch would only discover it.
  * **separation** — within the pending window, two transactions writing
    the same hot range are split into different batches (the follower is
    deferred one tick, bounded by `resolver_sched_defer_max`), so a batch
    carries at most one writer per hot range and intra-batch conflict
    cascades stop.
  * **serialization lanes** — hot-key write chains conflict with each
    other, not the world: captured into a per-range lane that drains in
    arrival (= version) order as single-writer sub-batches, one head per
    tick, they stop competing for slots that general traffic can use.
  * **pre-abort** — a predicted-doomed transaction is answered with the
    typed retryable `transaction_conflict_predicted` BEFORE device
    dispatch; the client refreshes its read version and retries with a
    snapshot that can actually win. A deterministic 1-in-N counter probe
    dispatches a predicted-doomed transaction anyway; a probe that
    COMMITS increments the mispredict counter the watchdog's
    `sched_mispredict` rule alerts on (core/watchdog.py, not ported yet).

Correctness invariant: scheduling only changes WHICH transactions reach
the resolver in WHICH batch — for any schedule, the resolver's verdicts
on the unscheduled submission order remain the bit-identical parity
baseline, and journal replay of the schedule actually dispatched stays
bit-for-bit through the clean serial oracle (tests/test_torch_scheduler.py).
The fully-off path (`resolver_sched` = "") hands batches through
untouched: no predictor state, no reorder, no extra telemetry series,
byte-identical compiled programs.

Determinism discipline: no wall clock, no rng — probing is counter-based,
ties break on arrival order, and every map iterates in insertion order,
so the same seed always yields the same schedule.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: sched.* span segments: the scheduler's own arc names, NOT part of the
#: commit waterfall's telescoping-sum registry — a select tick happens
#: outside any one transaction's latency.
SCHED_SEGMENTS = ("select", "preabort", "lane_drain", "observe",
                  "epoch_flip")

#: per-transaction decision codes (journaled in aggregate per version —
#: core/blackbox.py BBSched — and counted in snapshot()/telemetry)
DECISION_DISPATCH = "dispatch"
DECISION_DEFER = "defer"
DECISION_LANE = "lane"
DECISION_PREABORT = "preabort"
DECISION_PROBE = "probe"
DECISION_FORCED = "forced"

#: predictor score increments: an attributed first-witness abort is a
#: stronger contention signal than one host-observed conflict verdict,
#: and every committed write keeps a range's hotness tracking its WRITE
#: traffic — conflict probability scales with write rate x snapshot
#: staleness, so a range the scheduler is successfully protecting must
#: not decay cold and oscillate back into aborting
_WITNESS_WEIGHT = 2.0
_CONFLICT_WEIGHT = 1.0
_WRITE_WEIGHT = 1.0
#: scores below this after decay are dropped (bounds the map together
#: with _MAX_TRACKED without losing any range that still matters)
_SCORE_FLOOR = 1e-3


def _hex(b: bytes) -> str:
    return bytes(b).hex()


@dataclass
class SchedConfig:
    """Resolved `resolver_sched*` knob family (docs/scheduling.md knob
    table). Constructed from SERVER_KNOBS by default; tests and the
    smoke harness override fields directly."""

    enabled: bool = False
    window: int = 256
    hot_score: float = 4.0
    decay: float = 0.98
    preabort: bool = True
    probe_interval: int = 16
    lane_max: int = 8
    lane_depth: int = 32
    defer_max: int = 4
    mispredict_frac: float = 0.5

    @classmethod
    def from_knobs(cls) -> "SchedConfig":
        from ..core.knobs import SERVER_KNOBS as k

        mode = str(k.resolver_sched or "").strip().lower()
        return cls(
            enabled=bool(mode) and mode != "off",
            window=int(k.resolver_sched_window),
            hot_score=float(k.resolver_sched_hot_score),
            decay=float(k.resolver_sched_decay),
            preabort=bool(k.resolver_sched_preabort),
            probe_interval=max(1, int(k.resolver_sched_probe_interval)),
            lane_max=int(k.resolver_sched_lane_max),
            lane_depth=int(k.resolver_sched_lane_depth),
            defer_max=int(k.resolver_sched_defer_max),
            mispredict_frac=float(k.resolver_sched_mispredict_frac),
        )

    def as_dict(self) -> dict:
        return {"enabled": self.enabled, "window": self.window,
                "hot_score": self.hot_score, "decay": self.decay,
                "preabort": self.preabort,
                "probe_interval": self.probe_interval,
                "lane_max": self.lane_max, "lane_depth": self.lane_depth,
                "defer_max": self.defer_max,
                "mispredict_frac": self.mispredict_frac}


class ConflictPredictor:
    """Decayed per-key-range conflict scores + last-committed-write
    versions for hot ranges — the doom model.

    Fed two ways: the heat aggregator's consumable first-witness stream
    (attributed aborts, strongest signal, carries the convicting write
    version) and plain verdict feedback from every resolved batch
    (conflict verdicts bump the aborted read ranges; commit verdicts
    advance `last_write` for tracked write ranges). Both feeds key on the
    RAW conflict-range begin key, the same key the heat map and the shard
    map use, so a lane and a shard speak about the same range.

    Doom rule: a transaction is predicted doomed iff some read range's
    begin key is hot (score >= hot_score) AND that range's last committed
    write version exceeds the transaction's read snapshot. Under
    strict-serializable validation that transaction cannot commit — the
    prediction can only be WRONG when the tracked last_write is stale
    (e.g. the writer's version was GC'd into a fresh engine), which is
    exactly what the probe/mispredict counters measure."""

    #: retained scored ranges (load-ranked prune, like the heat map's
    #: MAX_RANGES — bounded state is the contract of every core map here)
    MAX_TRACKED = 1024

    def __init__(self, hot_score: float, decay: float):
        self.hot_score = float(hot_score)
        self.decay = float(decay)
        #: range begin key -> decayed conflict score
        self.scores: Dict[bytes, float] = {}
        #: range begin key -> newest committed write version (hot ranges)
        self.last_write: Dict[bytes, int] = {}
        self.witnesses_consumed = 0

    def tick(self) -> None:
        """One scheduling tick: decay every score, drop the dust."""
        if self.decay < 1.0 and self.scores:
            dead: List[bytes] = []
            for k in self.scores:
                s = self.scores[k] * self.decay
                if s < _SCORE_FLOOR:
                    dead.append(k)
                else:
                    self.scores[k] = s
            for k in dead:
                del self.scores[k]
                self.last_write.pop(k, None)

    def observe_witness(self, range_begin: bytes,
                        witness_version: Optional[int] = None) -> None:
        """One drained first-witness sample (core/heatmap.py
        drain_witnesses): the attributed range gains witness weight and,
        when the device named the convicting write's version, the
        last-write map learns it."""
        b = bytes(range_begin)
        self.scores[b] = self.scores.get(b, 0.0) + _WITNESS_WEIGHT
        self.witnesses_consumed += 1
        if witness_version is not None:
            lw = self.last_write.get(b)
            if lw is None or int(witness_version) > lw:
                self.last_write[b] = int(witness_version)

    def observe_conflict(self, range_begin: bytes) -> None:
        b = bytes(range_begin)
        self.scores[b] = self.scores.get(b, 0.0) + _CONFLICT_WEIGHT

    def note_commit(self, range_begin: bytes, version: int) -> None:
        """A committed write advances the range's last-write version —
        the fact the doom rule compares snapshots against — and adds the
        (small) write weight to its score, so sustained write traffic
        keeps a contended range hot even while pre-aborts are preventing
        the conflicts that would otherwise re-score it. Cold ranges'
        residue decays below _SCORE_FLOOR within a few ticks and the
        load-ranked prune bounds the map either way."""
        b = bytes(range_begin)
        self.scores[b] = self.scores.get(b, 0.0) + _WRITE_WEIGHT
        lw = self.last_write.get(b)
        if lw is None or int(version) > lw:
            self.last_write[b] = int(version)

    def score_of(self, range_begin: bytes) -> float:
        return self.scores.get(bytes(range_begin), 0.0)

    def is_hot(self, range_begin: bytes) -> bool:
        return self.scores.get(bytes(range_begin), 0.0) >= self.hot_score

    def doomed_range(self, txn) -> Optional[bytes]:
        """The convicting hot range when `txn` is predicted doomed, else
        None. First match in the transaction's own read-range order —
        deterministic, and the journaled `why` names a single range."""
        snap = int(txn.read_snapshot)
        for r in txn.read_conflict_ranges:
            b = bytes(r.begin)
            lw = self.last_write.get(b)
            if (lw is not None and lw > snap
                    and self.scores.get(b, 0.0) >= self.hot_score):
                return b
        return None

    def hot_ranges(self, n: int = 8) -> List[Tuple[bytes, float]]:
        """Hottest tracked ranges, score-descending (key ascending on
        ties — stable across runs)."""
        ranked = sorted(self.scores.items(),
                        key=lambda kv: (-kv[1], kv[0]))
        return [(k, v) for k, v in ranked[:n] if v >= self.hot_score]

    def prune(self) -> None:
        if len(self.scores) <= self.MAX_TRACKED:
            return
        ranked = sorted(self.scores.items(),
                        key=lambda kv: (-kv[1], kv[0]))
        self.scores = dict(ranked[: self.MAX_TRACKED])
        for k in [k for k in self.last_write if k not in self.scores]:
            del self.last_write[k]

    def snapshot(self) -> dict:
        return {
            "tracked_ranges": len(self.scores),
            "hot_ranges": [{"range_begin": _hex(k),
                            "score": round(v, 3)}
                           for k, v in self.hot_ranges(4)],
            "witnesses_consumed": self.witnesses_consumed,
        }


class SerializationLane:
    """One hot range's single-writer queue.

    Hot-key write chains conflict with each other, not the world: queued
    here they drain in arrival (= version) order, one head per scheduling
    tick, so each tick's batch carries at most one writer for the range —
    the rest stop burning dispatch slots they were doomed to lose. A lane
    goes DRAINING on a shard-map epoch flip (docs/scheduling.md "Lane
    state machine"): it accepts no new captures but keeps draining, so a
    reshard never strands a queued transaction; it retires once empty."""

    __slots__ = ("range_begin", "epoch", "entries", "draining",
                 "captured", "drained")

    def __init__(self, range_begin: bytes, epoch: int):
        self.range_begin = bytes(range_begin)
        self.epoch = int(epoch)
        self.entries: deque = deque()
        self.draining = False
        self.captured = 0
        self.drained = 0

    def as_dict(self) -> dict:
        return {"range_begin": _hex(self.range_begin),
                "epoch": self.epoch, "depth": len(self.entries),
                "state": "draining" if self.draining else "open",
                "captured": self.captured, "drained": self.drained}


@dataclass
class SchedPlan:
    """One select() tick's outcome: what to dispatch now, what to answer
    `transaction_conflict_predicted`, what stays pending — plus the
    aggregate decision counts the caller journals against the batch's
    commit version (core/blackbox.py record_sched)."""

    dispatch: List[Any] = field(default_factory=list)
    #: (entry, convicting range begin) pairs to pre-abort
    preaborts: List[Tuple[Any, bytes]] = field(default_factory=list)
    #: still-pending entries, arrival order preserved
    remaining: List[Any] = field(default_factory=list)
    #: decision code -> count this tick
    decided: Dict[str, int] = field(default_factory=dict)
    #: distinct convicting ranges behind this tick's pre-aborts (hex)
    preabort_ranges: Tuple[str, ...] = ()
    #: distinct lane ranges that captured or drained this tick (hex)
    lane_ranges: Tuple[str, ...] = ()


class ConflictScheduler:
    """The deterministic scheduler between admission and the batcher.

    Owns a ConflictPredictor and the serialization lanes; `select()` runs
    once per batching tick over the caller's pending window, and
    `observe_batch()` feeds every resolved batch's verdicts back. The
    heat aggregator, when attached, contributes its first-witness abort
    attributions through the consumable `drain_witnesses()` stream —
    never the peek-only display ring, so `cli heat` and the scheduler
    cannot double-count a sample.

    `entry_txn` adapts the caller's pending-entry shape (the wall-clock
    commit server queues `(txn, promise, t, meta)` tuples, the sim proxy
    `(txn, promise)`); everything else is shape-agnostic. Disabled
    (cfg.enabled False) the scheduler is inert: select() slices the
    window FIFO exactly as the caller would have, touching no state."""

    def __init__(self, cfg: Optional[SchedConfig] = None, heat=None,
                 entry_txn: Optional[Callable[[Any], Any]] = None,
                 name: str = "sched"):
        self.cfg = cfg if cfg is not None else SchedConfig.from_knobs()
        #: KeyRangeHeatAggregator (or None): witness feed + weight seed
        self.heat = heat
        self.entry_txn = entry_txn if entry_txn is not None else (
            lambda e: e)
        self.name = name
        self.predictor = ConflictPredictor(self.cfg.hot_score,
                                           self.cfg.decay)
        #: range begin key -> lane, insertion-ordered (drain order)
        self.lanes: Dict[bytes, SerializationLane] = {}
        #: shard-map epoch the lanes were derived under (-1 = static map)
        self.epoch = -1
        #: id(entry) -> ticks deferred (separation starvation bound)
        self._defers: Dict[int, int] = {}
        #: id(txn) -> convicting range for in-flight probes
        self._probes: Dict[int, bytes] = {}
        #: predicted-doomed occurrences, drives the 1-in-N probe cadence
        self._doomed_seen = 0
        self.counters: Dict[str, int] = {
            "ticks": 0, "examined": 0, "dispatched": 0, "deferred": 0,
            "laned": 0, "lane_drained": 0, "preaborts": 0, "probes": 0,
            "probe_ok": 0, "mispredicts": 0, "forced": 0, "reordered": 0,
            "epoch_flips": 0, "lanes_opened": 0, "lanes_retired": 0,
        }
        if self.cfg.enabled:
            # unified telemetry (core/telemetry.py): counters + predictor
            # gauges become `sched.<label>.*` series, the `fdbtpu_sched`
            # exposition family and the sched_mispredict rule's feed.
            # Only the enabled path registers: fully-off must add no
            # series (the byte-identical-off contract).
            from ..core import telemetry

            self.label = telemetry.hub().register_scheduler(self, name)
        else:
            self.label = None

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    # -- scheduling ----------------------------------------------------------
    def select(self, pending: Sequence[Any], cap: int) -> SchedPlan:
        """One batching tick: pick up to `cap` entries to dispatch from
        `pending` (arrival order), route hot writers through lanes,
        pre-abort the predicted-doomed, defer separation losers. The
        input is not mutated; `plan.remaining` is the caller's new
        pending queue (arrival order preserved among kept entries)."""
        if not self.cfg.enabled or cap <= 0:
            return SchedPlan(dispatch=list(pending[:max(0, cap)]),
                             remaining=list(pending[max(0, cap):]))
        self.counters["ticks"] += 1
        self.predictor.tick()
        self._drain_heat_witnesses()
        decided: Dict[str, int] = {}
        preaborts: List[Tuple[Any, bytes]] = []
        preabort_ranges: List[str] = []
        lane_ranges: List[str] = []
        dispatch: List[Any] = []

        window = list(pending[: self.cfg.window])
        tail = list(pending[self.cfg.window:])
        self.counters["examined"] += len(window)

        # 1. lane capture: a hot-range writer joins its range's lane (one
        #    writer per range per batch is the lane's whole point). Lanes
        #    open lazily up to lane_max; draining lanes and full lanes
        #    capture nothing — overflow rides the normal flow.
        normal: List[Any] = []
        for e in window:
            lane = self._lane_for(self.entry_txn(e))
            if lane is not None:
                lane.entries.append(e)
                lane.captured += 1
                self.counters["laned"] += 1
                decided[DECISION_LANE] = decided.get(DECISION_LANE, 0) + 1
                if _hex(lane.range_begin) not in lane_ranges:
                    lane_ranges.append(_hex(lane.range_begin))
            else:
                normal.append(e)

        # 2. lane candidates: one head per lane per tick, lane-creation
        #    order. A doomed head is pre-aborted (it queued behind the
        #    writer that convicts it; a fresh snapshot is its only way
        #    through) and the next head takes the slot. The surviving
        #    head is a CANDIDATE only — whether it drains this tick is
        #    decided after the normal flow is known (3b): its reads must
        #    not land behind a same-batch hot write or it aborts
        #    in-batch, the exact cascade lanes exist to prevent.
        lane_candidates: List[Tuple[bytes, SerializationLane, Any, int]] = []
        for key in list(self.lanes):
            lane = self.lanes[key]
            while lane.entries and len(lane_candidates) < cap:
                e = lane.entries[0]
                act = self._doom_action(self.entry_txn(e))
                if act == DECISION_PREABORT:
                    lane.entries.popleft()
                    self._forget(e)
                    preaborts.append((e, key))
                    if _hex(key) not in preabort_ranges:
                        preabort_ranges.append(_hex(key))
                    decided[DECISION_PREABORT] = \
                        decided.get(DECISION_PREABORT, 0) + 1
                    continue
                lane_candidates.append((key, lane, e, act))
                break   # single writer per lane per tick

        # 3. normal flow: pre-abort the doomed, separate likely
        #    in-batch-conflicting pairs into different ticks, dispatch
        #    the rest FIFO. Two separation rules, both bounded by
        #    defer_max: a second WRITER of a hot range already written
        #    by this tick's dispatch set waits a tick (write-write), and
        #    a hot writer whose READS intersect the hot ranges written
        #    by already-accepted back entries waits a tick — it would be
        #    ordered into the back of the batch BEHIND the write that
        #    convicts it (read-write; the dominant in-batch abort under
        #    multi-key hot transactions).
        kept: List[Any] = []
        #: hot ranges written by this tick's dispatch set (lane
        #: candidates included: their heads are hot-range writers by
        #: construction) — the write-write separation set
        written_hot = set()
        for _k, _l, e, _a in lane_candidates:
            for r in self.entry_txn(e).write_conflict_ranges:
                b = bytes(r.begin)
                if self.predictor.is_hot(b):
                    written_hot.add(b)
        #: hot ranges written by accepted NORMAL-flow back entries only:
        #: lane heads dispatch after the back, so lane writes cannot
        #: convict back reads — only back writes convict back reads
        back_written: set = set()
        budget = max(0, cap - len(lane_candidates))
        for e in normal:
            if len(dispatch) >= budget:
                kept.append(e)   # FIFO overflow: no decision, no defer
                continue
            txn = self.entry_txn(e)
            forced = self._defers.get(id(e), 0) >= self.cfg.defer_max
            act = DECISION_DISPATCH if forced else self._doom_action(txn)
            if forced:
                self.counters["forced"] += 1
                decided[DECISION_FORCED] = \
                    decided.get(DECISION_FORCED, 0) + 1
            if act == DECISION_PREABORT:
                doomed = self.predictor.doomed_range(txn)
                self._forget(e)
                preaborts.append((e, doomed))
                if _hex(doomed) not in preabort_ranges:
                    preabort_ranges.append(_hex(doomed))
                decided[DECISION_PREABORT] = \
                    decided.get(DECISION_PREABORT, 0) + 1
                continue
            if act == DECISION_DEFER:
                self._defer(e, kept, decided)
                continue
            hot_writes = {bytes(r.begin)
                          for r in txn.write_conflict_ranges
                          if self.predictor.is_hot(bytes(r.begin))}
            if hot_writes & written_hot and not forced:
                # write-write separation: a second writer of an
                # already-written hot range waits for the next batch
                self._defer(e, kept, decided)
                continue
            if hot_writes and not forced:
                hot_reads = {bytes(r.begin)
                             for r in txn.read_conflict_ranges
                             if self.predictor.is_hot(bytes(r.begin))}
                if hot_reads & back_written:
                    # read-write separation: this writer would be
                    # reordered behind the very write that convicts it
                    self._defer(e, kept, decided)
                    continue
            written_hot |= hot_writes
            back_written |= hot_writes
            self._forget(e)
            dispatch.append(e)
            if act == DECISION_PROBE:
                decided[DECISION_PROBE] = \
                    decided.get(DECISION_PROBE, 0) + 1

        # 3b. lane drain: a candidate head whose reads intersect the
        #     batch's accepted hot writes (normal back entries + earlier
        #     lane heads) stays queued a tick instead of aborting
        #     in-batch — bounded by defer_max like any separation loser.
        lane_dispatch: List[Any] = []
        lane_written: set = set()
        for key, lane, e, act in lane_candidates:
            txn = self.entry_txn(e)
            hot_reads = {bytes(r.begin)
                         for r in txn.read_conflict_ranges
                         if self.predictor.is_hot(bytes(r.begin))}
            if hot_reads & (back_written | lane_written):
                if self._defers.get(id(e), 0) < self.cfg.defer_max:
                    self._defers[id(e)] = self._defers.get(id(e), 0) + 1
                    self.counters["deferred"] += 1
                    decided[DECISION_DEFER] = \
                        decided.get(DECISION_DEFER, 0) + 1
                    continue   # head stays queued; the lane skips a tick
                self.counters["forced"] += 1
                decided[DECISION_FORCED] = \
                    decided.get(DECISION_FORCED, 0) + 1
            lane.entries.popleft()
            lane.drained += 1
            self.counters["lane_drained"] += 1
            self._forget(e)
            lane_dispatch.append(e)
            lane_written |= {bytes(r.begin)
                            for r in txn.write_conflict_ranges
                            if self.predictor.is_hot(bytes(r.begin))}
            if act == DECISION_PROBE:
                decided[DECISION_PROBE] = \
                    decided.get(DECISION_PROBE, 0) + 1
        for key in list(self.lanes):
            lane = self.lanes[key]
            if lane.draining and not lane.entries:
                del self.lanes[key]
                self.counters["lanes_retired"] += 1

        # 4. window reorder (separation of likely-conflicting PAIRS): a
        #    batch resolves in list order, so every hot-range writer —
        #    normal-flow stragglers first, then the laned single-writers
        #    — moves to the back of the batch. Cold entries and hot-range
        #    readers keep their arrival order in front of them: a
        #    fresh-snapshot reader ordered before the batch's writer of
        #    its range commits; ordered after it, it aborts.
        def _writes_hot(e) -> bool:
            return any(self.predictor.is_hot(bytes(r.begin))
                       for r in self.entry_txn(e).write_conflict_ranges)

        front = [e for e in dispatch if not _writes_hot(e)]
        back = [e for e in dispatch if _writes_hot(e)]
        if back or lane_dispatch:
            self.counters["reordered"] += len(back) + len(lane_dispatch)
        dispatch = front + back + lane_dispatch

        decided[DECISION_DISPATCH] = len(dispatch)
        self.counters["dispatched"] += len(dispatch)
        self.counters["preaborts"] += len(preaborts)
        self.predictor.prune()
        return SchedPlan(dispatch=dispatch, preaborts=preaborts,
                         remaining=kept + tail, decided=decided,
                         preabort_ranges=tuple(preabort_ranges),
                         lane_ranges=tuple(lane_ranges))

    def _defer(self, e, kept: List[Any], decided: Dict[str, int]) -> None:
        self._defers[id(e)] = self._defers.get(id(e), 0) + 1
        self.counters["deferred"] += 1
        decided[DECISION_DEFER] = decided.get(DECISION_DEFER, 0) + 1
        kept.append(e)

    def _forget(self, e) -> None:
        self._defers.pop(id(e), None)

    def _lane_for(self, txn) -> Optional[SerializationLane]:
        """The open lane that should capture `txn` (None = normal flow):
        first hot write range with lane capacity, lazily opening a lane
        while under lane_max. Read-only transactions and cold writers
        never lane."""
        for r in txn.write_conflict_ranges:
            b = bytes(r.begin)
            if not self.predictor.is_hot(b):
                continue
            lane = self.lanes.get(b)
            if lane is None:
                if len(self.lanes) >= self.cfg.lane_max:
                    continue
                lane = self.lanes[b] = SerializationLane(b, self.epoch)
                self.counters["lanes_opened"] += 1
            if lane.draining or len(lane.entries) >= self.cfg.lane_depth:
                continue
            return lane
        return None

    def _doom_action(self, txn) -> str:
        """Classify one transaction against the doom model: DISPATCH,
        PREABORT, PROBE (counter-based 1-in-N doomed dispatch that keeps
        the predictor honest), or DEFER (pre-abort knob off: separation
        is the only tool, the defer_max bound still applies)."""
        doomed = self.predictor.doomed_range(txn)
        if doomed is None:
            return DECISION_DISPATCH
        self._doomed_seen += 1
        if self._doomed_seen % self.cfg.probe_interval == 0:
            self.counters["probes"] += 1
            if len(self._probes) >= 4096:
                # bound the in-flight probe map: a probe whose verdict
                # never came back (dispatch error) must not pin memory
                self._probes.pop(next(iter(self._probes)))
            self._probes[id(txn)] = doomed
            return DECISION_PROBE
        if self.cfg.preabort:
            return DECISION_PREABORT
        return DECISION_DEFER

    # -- feedback ------------------------------------------------------------
    def observe_batch(self, transactions: Sequence[Any],
                      verdicts: Sequence[Any], version: int) -> None:
        """One resolved batch's verdicts: conflicts bump the predictor's
        scores on the aborted read ranges, commits advance last-write on
        tracked write ranges, and in-flight probes settle — a probe that
        committed is a MISPREDICT (the model said doomed)."""
        if not self.cfg.enabled:
            return
        from ..core.types import TransactionCommitResult

        committed = int(TransactionCommitResult.COMMITTED)
        too_old = int(TransactionCommitResult.TOO_OLD)
        v = int(version)
        for t, txn in enumerate(transactions):
            verdict = int(verdicts[t])
            probe_range = self._probes.pop(id(txn), None)
            if verdict == committed:
                for r in txn.write_conflict_ranges:
                    self.predictor.note_commit(r.begin, v)
                if probe_range is not None:
                    self.counters["mispredicts"] += 1
            elif verdict != too_old:
                for r in txn.read_conflict_ranges:
                    self.predictor.observe_conflict(r.begin)
                if probe_range is not None:
                    self.counters["probe_ok"] += 1

    def _drain_heat_witnesses(self) -> None:
        if self.heat is None:
            return
        drain = getattr(self.heat, "drain_witnesses", None)
        if drain is None:
            return
        for sample in drain():
            rb = sample.get("range_begin")
            if rb is None:
                continue
            self.predictor.observe_witness(rb,
                                           sample.get("witness_version"))

    # -- reshard interplay ---------------------------------------------------
    def notify_epoch(self, epoch: int) -> None:
        """Shard-map epoch flip (server/reshard.py): lane assignments
        were derived under the OLD map, so every open lane flips to
        DRAINING — it keeps draining (never strands a queued transaction)
        but captures nothing; fresh captures re-derive lanes under the
        new epoch as ranges prove hot again."""
        epoch = int(epoch)
        if epoch == self.epoch:
            return
        self.epoch = epoch
        self.counters["epoch_flips"] += 1
        for lane in self.lanes.values():
            lane.draining = True

    def flush(self) -> List[Any]:
        """Hand back EVERY entry still queued in a lane, lane-creation
        order, and retire the lanes — the shutdown/teardown path, so a
        stopping server can answer or dispatch each queued transaction
        instead of dropping its promise."""
        out: List[Any] = []
        for lane in self.lanes.values():
            out.extend(lane.entries)
            lane.entries.clear()
        self.counters["lanes_retired"] += len(self.lanes)
        self.lanes.clear()
        return out

    # -- read model ----------------------------------------------------------
    def mispredict_frac(self) -> float:
        settled = self.counters["probe_ok"] + self.counters["mispredicts"]
        if settled == 0:
            return 0.0
        return self.counters["mispredicts"] / settled

    def pending_laned(self) -> int:
        return sum(len(lane.entries) for lane in self.lanes.values())

    def snapshot(self) -> dict:
        return {
            "config": self.cfg.as_dict(),
            "epoch": self.epoch,
            "counters": dict(self.counters),
            "mispredict_frac": round(self.mispredict_frac(), 4),
            "lanes": [lane.as_dict() for lane in self.lanes.values()],
            "pending_laned": self.pending_laned(),
            "predictor": self.predictor.snapshot(),
        }
