"""Durable black-box journal: the cluster's flight data recorder.

Port of ``foundationdb_tpu/core/blackbox.py``.

Every observability layer before this one dies with its process — spans
live in a bounded ring, watchdog incidents in the engine, the
ResilientEngine journal in test-harness memory, reshard ops in the
controller. Nothing could answer "why did transaction T abort at version
V" an hour later. This module is the narration substrate: a bounded,
segment-rotated, strictly append-only ON-DISK structured event log into
which the existing producers sink records they already compute —

  * per-batch resolution records (the transactions, verdict vector and
    GC horizon — enough to DIFFERENTIALLY REPLAY any persisted window
    through the clean serial oracle, tools/forensics.py);
  * span records past the tail sampler (the campaign's retained
    waterfalls), watchdog alert lifecycle transitions and correlated
    incidents, ResilientEngine health transitions and flight-recorder
    dumps, reshard phase arcs and epoch flips, admission/shed counters,
    keyspace-heat briefs, injected fault windows.

Every event rides one `BBEnvelope` stamped {seq, t, commit_version,
epoch, shard, proc, trace_id}, so heterogeneous signals join on
version + trace id (the Canopy per-request-fusion idea, applied to
commit forensics). Payload schemas are CLOSED: `BLACKBOX_EVENT_REGISTRY`
maps every event kind to its wire-registered record type, the same
table as the JAX package's (tests/test_torch_blackbox.py holds them
equal).

Format: each segment file is `MAGIC + version` then a run of frames
`[u32 length][u32 crc32][wire payload]` (core/wire.py named records —
byte-stable, schema-evolvable). Writes are append-only and flushed per
record; a crash mid-frame leaves a partial tail the reader TOLERATES
(it returns every complete, crc-clean prefix record and stops).
Segments rotate at `resolver_blackbox_segment_bytes` and the oldest is
deleted past `resolver_blackbox_segments` — the retention window is
sized in the same spirit as the MVCC window, so a replayed slice's
too-old gate still holds (forensics reports `coverage_ok` honestly).

Clock: `now_fn` defaults to `span_now()` — the sim's virtual clock when
a deterministic scheduler is installed, the wall clock otherwise — so
same-seed deterministic runs produce BYTE-IDENTICAL journals
(tests/test_blackbox.py pins this).

Cost discipline: the disabled path (`resolver_blackbox` knob off, no
journal installed) is one list-index check per producer site; nothing
allocates (`blackbox_allocations` is the regression counter, the
NULL_SPAN pattern). Recording never touches a device and never raises
into the serving path — abort sets are bit-identical on/off.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import buggify, wire
from .trace import span_now

#: allocation counter for the disabled-path regression guard (the
#: core/trace.py span_allocations pattern): bumped whenever the journal
#: allocates a record — with no journal installed, a full resolve loop
#: must leave it untouched (tests/test_blackbox.py).
blackbox_allocations = [0]

#: segment file header: magic + format version
MAGIC = b"FBBX"
SEGMENT_VERSION = 1
_HEADER = MAGIC + bytes([SEGMENT_VERSION])
#: per-record frame: little-endian (payload length, crc32 of payload)
_FRAME = struct.Struct("<II")


# -- event records -------------------------------------------------------------
# One dataclass per event kind; all wire-registered named records, so a
# vN journal read by a vN+1 binary tolerates added/dropped fields.

@dataclass
class BBEnvelope:
    """The stamp every event carries — the join surface of the journal."""

    seq: int = 0
    t: float = 0.0
    kind: str = ""
    commit_version: int = -1
    epoch: int = -1
    shard: int = -1
    proc: str = ""
    trace_id: Any = None
    payload: Any = None


@dataclass
class BBBatch:
    """One resolved batch — the differential-replay unit: transactions +
    verdicts + horizon reproduce the serial oracle's state machine."""

    version: int = 0
    new_oldest: int = 0
    txns: Tuple = ()
    verdicts: Tuple = ()
    engine: str = ""
    served_by: str = ""
    witness: Tuple = ()   # sampled first-witness attribution dicts


@dataclass
class BBSpan:
    """A span record past the tail sampler (core/trace.py layout)."""

    name: str = ""
    trace: Any = None
    begin: float = 0.0
    end: float = 0.0
    proc: str = ""
    detail: Dict = field(default_factory=dict)


@dataclass
class BBHealth:
    """A ResilientEngine health-state transition (fault/resilient.py)."""

    label: str = ""
    prev: str = ""
    state: str = ""


@dataclass
class BBFlight:
    """A flight-recorder dump at a failover/quarantine boundary."""

    reason: str = ""
    version: int = -1
    records: Tuple = ()


@dataclass
class BBAlert:
    """One watchdog alert lifecycle edge (core/watchdog.py ring entry)."""

    alert: str = ""
    series: str = ""
    state: str = ""
    value: float = 0.0
    detail: str = ""


@dataclass
class BBIncident:
    """A correlated incident at campaign close (core/watchdog.py)."""

    id: int = 0
    t0: float = 0.0
    t1: Optional[float] = None
    alerts: Tuple = ()
    windows: Tuple = ()
    explained: bool = False
    explanation: Optional[str] = None
    summary: str = ""


@dataclass
class BBReshard:
    """One reshard phase edge (server/reshard.py ReshardOp arc); the
    `flip` phase carries the new epoch + flip version + split keys, so
    routing is reconstructible from the journal alone."""

    op_id: int = 0
    kind: str = ""
    phase: str = ""
    begin: str = ""
    end: Optional[str] = None
    epoch: int = -1
    flip_version: int = -1
    splits: Tuple = ()
    blackout_ms: float = 0.0
    donor_sids: Tuple = ()
    recipient_sid: int = -1
    error: Optional[str] = None


@dataclass
class BBAdmission:
    """Admission/shed counter snapshot (server/ratekeeper.py totals)."""

    label: str = ""
    admitted: int = 0
    rejected: int = 0
    rate: float = 0.0
    weights: Dict = field(default_factory=dict)


@dataclass
class BBHeat:
    """A keyspace-heat brief (core/heatmap.py brief() fields)."""

    conflicts: int = 0
    occupancy_frac: float = 0.0
    concentration: float = 0.0
    top_range: Optional[str] = None
    top_share: float = 0.0


@dataclass
class BBSched:
    """One scheduling tick's decisions against the batch version it
    produced (pipeline/scheduler.py SchedPlan): how many transactions
    were dispatched / deferred / laned / pre-aborted / probed this tick,
    and WHICH ranges convicted the pre-aborts and hosted the lanes — the
    `why` behind a deferred or refused transaction that `cli explain`
    renders for the version."""

    version: int = 0
    dispatched: int = 0
    deferred: int = 0
    laned: int = 0
    preaborted: int = 0
    probes: int = 0
    forced: int = 0
    lanes: int = 0
    pending: int = 0
    epoch: int = -1
    preabort_ranges: Tuple = ()
    lane_ranges: Tuple = ()


@dataclass
class BBSnapshotEvt:
    """One engine-state snapshot written beside the journal segments
    (fault/recovery.py SnapshotManager): the recovery floor moves to
    `version`, bounded by `entries` distinct-version write batches (the
    handoff pre-copy coalescing, NOT history length)."""

    version: int = 0
    oldest: int = 0
    entries: int = 0
    bytes: int = 0
    ms: float = 0.0
    path: str = ""


@dataclass
class BBRecovery:
    """One crash-stop recovery arc (fault/recovery.py recover()): where
    the state came from (snapshot version + replayed journal suffix),
    whether retained history fully covered the gap (`coverage_ok` /
    `mode`), verdict parity of the differential replay, and the blackout
    the restart cost — `cli recovery` renders exactly this record."""

    mode: str = ""
    coverage_ok: bool = True
    snapshot_version: int = -1
    recovered_version: int = -1
    oldest: int = 0
    snapshot_entries: int = 0
    replayed_batches: int = 0
    verdict_mismatches: int = 0
    blackout_ms: float = 0.0
    progcache_hits: int = 0
    progcache_misses: int = 0
    warm_ms: float = 0.0
    error: Optional[str] = None


@dataclass
class BBWindow:
    """An injected fault / maintenance window (the nemesis' kinded
    records — partition, device_incident, reshard, warmup, ...)."""

    kind: str = ""
    t0: float = 0.0
    t1: float = 0.0
    detail: Dict = field(default_factory=dict)


@dataclass
class BBScenario:
    """The scenario-atlas stamp (real/scenarios.py): which named
    production recipe this campaign ran, with its measured heat/abort
    signature — load concentration, the top range's identity and share,
    the verdict mix — so forensics over a bare journal can answer
    "which workload shape produced these batches?"."""

    name: str = ""
    seed: int = 0
    engine_mode: str = ""
    concentration: float = 0.0
    top_range: Optional[str] = None
    top_share: float = 0.0
    abort_frac: float = 0.0
    throttle_frac: float = 0.0
    witnesses: int = 0


#: The CLOSED event schema: kind -> wire record type. The journal format
#: can only grow through this table, which equals the JAX package's.
BLACKBOX_EVENT_REGISTRY = {
    "batch": BBBatch,
    "span": BBSpan,
    "health": BBHealth,
    "flight": BBFlight,
    "alert": BBAlert,
    "incident": BBIncident,
    "reshard": BBReshard,
    "admission": BBAdmission,
    "heat": BBHeat,
    "fault_window": BBWindow,
    "sched": BBSched,
    "snapshot": BBSnapshotEvt,
    "recovery": BBRecovery,
    "scenario": BBScenario,
}

for _cls in (BBEnvelope, *BLACKBOX_EVENT_REGISTRY.values()):
    wire.register_record(_cls)


# -- the journal ---------------------------------------------------------------

class BlackboxJournal:
    """Bounded, segment-rotated, append-only on-disk event log."""

    def __init__(self, directory: str,
                 segment_bytes: Optional[int] = None,
                 max_segments: Optional[int] = None,
                 ring: Optional[int] = None,
                 now_fn=span_now, proc: str = "",
                 fresh: bool = False,
                 fsync_interval: Optional[int] = None,
                 disk: Optional[Any] = None):
        """`fresh=True` truncates any retained segments first — a
        campaign reusing a deterministic directory (`make chaos-drift`
        re-run) must not append a second event stream whose commit
        versions collide with the first run's; reopening to CONTINUE a
        journal (a restarted long-lived resolver) keeps the default."""
        from .knobs import SERVER_KNOBS

        self.directory = str(directory)
        if fresh:
            for p in _segment_paths(self.directory):
                try:
                    os.remove(p)
                except OSError:
                    pass
        self.segment_bytes = int(
            segment_bytes if segment_bytes is not None
            else SERVER_KNOBS.resolver_blackbox_segment_bytes)
        self.max_segments = int(
            max_segments if max_segments is not None
            else SERVER_KNOBS.resolver_blackbox_segments)
        self.now_fn = now_fn
        self.proc = proc
        os.makedirs(self.directory, exist_ok=True)
        #: in-memory ring of recent envelopes (live explain on a running
        #: process reads this instead of round-tripping the disk)
        self.ring: deque = deque(maxlen=int(
            ring if ring is not None
            else SERVER_KNOBS.resolver_blackbox_ring))
        self.events_written = 0
        self.dropped_errors = 0
        #: fsync cadence (resolver_blackbox_fsync_interval): 0 = flush
        #: per record only (the OS may buffer a crash-window tail); N>=1
        #: = os.fsync every N records — acked implies durable at N=1
        #: (docs/observability.md "crash-window contract")
        self.fsync_interval = int(
            fsync_interval if fsync_interval is not None
            else SERVER_KNOBS.resolver_blackbox_fsync_interval)
        self.fsyncs = 0
        self.fsync_ms = 0.0
        self._since_fsync = 0
        #: optional DiskFaults hook (fault/inject.py) — the disk nemesis'
        #: entry point into the journal's writes
        self.disk = disk
        #: shed-to-memory accounting: events the DISK refused but the
        #: in-memory ring kept — live explain still sees them, and
        #: summary() reports the durability gap honestly instead of
        #: silently narrowing the journal's coverage
        self.shed_events = 0
        self.durability_gap = False
        #: whole-journal accounting for summary() — the ring is bounded,
        #: so kind counts and the version range are tracked at record()
        #: time, never derived from whatever the ring still holds
        self._kind_counts: Dict[str, int] = {}
        self._v_min: Optional[int] = None
        self._v_max: Optional[int] = None
        existing = _segment_paths(self.directory)
        self._seg_index = (
            _segment_index(existing[-1]) + 1 if existing else 1)
        if existing:
            # reopening a directory: sequence numbers continue past the
            # newest retained record (rotation may have dropped seq 0)
            evs = read_journal(self.directory)
            self._seq = evs[-1].seq + 1 if evs else 0
        else:
            self._seq = 0
        self._file = None
        self._seg_bytes_written = 0
        self._open_segment()

    # -- writing -------------------------------------------------------------
    def _seg_path(self, index: int) -> str:
        return os.path.join(self.directory, f"bbox-{index:06d}.seg")

    def _open_segment(self) -> None:
        path = self._seg_path(self._seg_index)
        self._file = open(path, "ab")
        if self._file.tell() == 0:
            self._file.write(_HEADER)
            self._file.flush()
        self._seg_bytes_written = self._file.tell()

    def _rotate(self) -> None:
        if buggify.buggify():
            # BUGGIFY: rotation mid-append — the process died after
            # starting a frame but before completing it, then rotated on
            # restart: the closed segment carries a torn junk tail every
            # reader (read_segment, strict_parse, recovery replay) must
            # absorb without losing the complete frames before it
            try:
                self._file.write(_FRAME.pack(1 << 20, 0) + b"\xde\xad")
                self._file.flush()
            except OSError:
                pass
        self._file.close()
        self._seg_index += 1
        self._open_segment()
        paths = _segment_paths(self.directory)
        while len(paths) > max(1, self.max_segments):
            try:
                os.remove(paths.pop(0))
            except OSError:
                self.dropped_errors += 1
                break

    def _flush(self) -> None:
        """Flush, then fsync every `fsync_interval` records. fsync_ms is
        wall-clock observability only (never journaled), so same-seed
        byte-identical journals are unaffected."""
        self._file.flush()
        if self.fsync_interval > 0:
            self._since_fsync += 1
            if self._since_fsync >= self.fsync_interval:
                t0 = time.perf_counter()
                os.fsync(self._file.fileno())
                self.fsync_ms += (time.perf_counter() - t0) * 1e3
                self.fsyncs += 1
                self._since_fsync = 0

    def _append(self, data: bytes) -> bool:
        """One framed record to the segment file; False = the disk did
        not take it (the caller sheds the event to the memory ring)."""
        try:
            if self.disk is not None:
                # the disk nemesis: may stall (sleep), raise ENOSPC, tear
                # the write (OSError carrying the prefix that DID land),
                # or bit-rot the payload in passing (crc catches at read)
                data = self.disk.apply("journal", data)
            if buggify.buggify():
                # BUGGIFY: short write — only a prefix of the frame
                # reaches the segment (the crash-mid-append shape); the
                # reader must tolerate the torn tail and the journal must
                # rotate so later records stay parseable
                self._file.write(data[:max(1, len(data) // 2)])
                self._file.flush()
                raise OSError("buggify: short segment write")
            self._file.write(data)
            self._flush()
            return True
        except (OSError, ValueError) as e:
            # ValueError covers a write on a file another layer already
            # closed (teardown races, the nemesis killing the handle) —
            # same shedding contract as a disk refusal
            prefix = getattr(e, "prefix", None)
            if prefix:
                # a torn write persists the prefix that reached the disk
                # before failing — exactly what the crc-framed reader
                # tolerates (read_segment stops at the torn frame)
                try:
                    self._file.write(prefix)
                    self._file.flush()
                except (OSError, ValueError):
                    pass
            return False

    def record(self, kind: str, payload: Any, commit_version: int = -1,
               epoch: int = -1, shard: int = -1, trace_id: Any = None,
               proc: Optional[str] = None) -> None:
        """Append one event. Never raises into the caller: the journal is
        observational — a full disk degrades forensics, not serving. A
        write the disk refuses is SHED TO MEMORY: the bounded ring keeps
        the envelope for live explain, `shed_events`/`durability_gap`
        report the coverage hole honestly, and the on-disk sequence stays
        contiguous (the shed event's seq is reused by the next durable
        record, so strict_parse still proves no silent gaps)."""
        blackbox_allocations[0] += 1
        env = BBEnvelope(
            seq=self._seq, t=round(float(self.now_fn()), 6), kind=kind,
            commit_version=int(commit_version), epoch=int(epoch),
            shard=int(shard), proc=self.proc if proc is None else proc,
            trace_id=trace_id, payload=payload)
        try:
            raw = wire.dumps(env)
        except (ValueError, TypeError):
            self.dropped_errors += 1
            return
        data = _FRAME.pack(len(raw), zlib.crc32(raw)) + raw
        self.ring.append(env)
        self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
        if kind == "batch":
            v = int(payload.version)
            self._v_min = v if self._v_min is None else min(self._v_min, v)
            self._v_max = v if self._v_max is None else max(self._v_max, v)
        if not self._append(data):
            # a failed write may have left a torn frame mid-segment, and
            # the reader stops at the first torn frame — rotate so later
            # records land in a fresh segment instead of appending
            # unreadably after the garbage
            self.dropped_errors += 1
            self.shed_events += 1
            self.durability_gap = True
            try:
                self._rotate()
            except OSError:
                pass
            return
        self._seq += 1
        self.events_written += 1
        self._seg_bytes_written += len(data)
        if self._seg_bytes_written >= self.segment_bytes:
            self._rotate()

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.flush()
                self._file.close()
            except OSError:
                pass
            self._file = None

    # -- read model ----------------------------------------------------------
    def events(self) -> List[BBEnvelope]:
        """Recent envelopes from the in-memory ring (live explain)."""
        return list(self.ring)

    def summary(self) -> dict:
        """The campaign-report `blackbox` fragment (`cli blackbox`).
        Counts cover the WHOLE journal's lifetime (tracked at record()
        time), not just what the bounded ring still holds; note
        version_range spans written history — rotation may have dropped
        its low end from disk (`cli blackbox` shows retained coverage)."""
        return {
            "dir": self.directory,
            "events": self.events_written,
            "segments": len(_segment_paths(self.directory)),
            "dropped_errors": self.dropped_errors,
            "kinds": dict(self._kind_counts),
            "version_range": ([self._v_min, self._v_max]
                              if self._v_min is not None else None),
            # durability accounting (docs/observability.md "crash-window
            # contract"): fsync cadence + cost, and the honest flag for
            # events the disk refused but the memory ring kept
            "fsyncs": self.fsyncs,
            "fsync_ms": round(self.fsync_ms, 3),
            "fsync_interval": self.fsync_interval,
            "shed_events": self.shed_events,
            "durability_gap": self.durability_gap,
        }


# -- reading -------------------------------------------------------------------

def _segment_index(path: str) -> int:
    name = os.path.basename(path)
    return int(name[len("bbox-"):-len(".seg")])


def _segment_paths(directory: str) -> List[str]:
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("bbox-") and n.endswith(".seg")]
    except OSError:
        return []
    return [os.path.join(directory, n) for n in sorted(names)]


def read_segment(path: str) -> List[BBEnvelope]:
    """Every complete, crc-clean record of one segment; a torn or
    truncated tail (crash mid-append) ends the read without raising."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    if len(data) < len(_HEADER) or data[:len(MAGIC)] != MAGIC:
        return []
    out: List[BBEnvelope] = []
    off = len(_HEADER)
    n = len(data)
    while off + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + length
        if end > n:
            break                       # truncated tail frame
        raw = data[off + _FRAME.size:end]
        if zlib.crc32(raw) != crc:
            break                       # torn tail frame
        try:
            env = wire.loads(raw)
        except (ValueError, KeyError, TypeError):
            break
        out.append(env)
        off = end
    return out


def read_journal(directory: str) -> List[BBEnvelope]:
    """Every readable event across the retained segments, oldest first."""
    out: List[BBEnvelope] = []
    for path in _segment_paths(directory):
        out.extend(read_segment(path))
    return out


# -- process-global installation ----------------------------------------------
#: the one installed journal (None = disabled: every producer site pays
#: one list-index check and allocates nothing)
_g: List[Optional[BlackboxJournal]] = [None]


def enabled() -> bool:
    return _g[0] is not None


def active() -> Optional[BlackboxJournal]:
    return _g[0]


def install(journal: BlackboxJournal) -> BlackboxJournal:
    _g[0] = journal
    # the installed journal is the process's durable record — register
    # its durability accounting with the telemetry hub (weakly, like
    # every other source) so `blackbox.<label>.*` series exist wherever
    # a journal is writing (docs/observability.md crash-window contract)
    from . import telemetry

    journal.label = telemetry.hub().register_blackbox(
        journal, journal.proc or "blackbox")
    return journal


def uninstall() -> Optional[BlackboxJournal]:
    """Detach and close the installed journal (idempotent)."""
    j, _g[0] = _g[0], None
    if j is not None:
        j.close()
    return j


def knob_directory() -> Optional[str]:
    """The journal directory the `resolver_blackbox` knob selects: None
    when off ("" / "off"); `resolver_blackbox_dir` when "on"; any other
    value is itself the directory. Callers that run REPEATEDLY with
    restarting version streams (the chaos campaigns) must place each run
    in its own subdirectory of this — a shared directory opened fresh
    per run would leave every earlier run's report pointing at a wiped
    journal."""
    from .knobs import SERVER_KNOBS

    sel = str(SERVER_KNOBS.resolver_blackbox or "").strip()
    if not sel or sel.lower() == "off":
        return None
    return (str(SERVER_KNOBS.resolver_blackbox_dir)
            if sel.lower() == "on" else sel)


def journal_from_knobs(proc: str = "",
                       fresh: bool = False) -> Optional[BlackboxJournal]:
    """A journal per the `resolver_blackbox` knob (see knob_directory);
    `fresh` truncates retained segments first."""
    directory = knob_directory()
    if directory is None:
        return None
    return BlackboxJournal(directory, proc=proc, fresh=fresh)


# -- producer sinks ------------------------------------------------------------
# Each helper is the ONE way its producer records: check-first (no
# payload is built when disabled), never raising, stamped consistently.

def record_event(kind: str, payload: Any, **stamp: Any) -> None:
    j = _g[0]
    if j is None:
        return
    j.record(kind, payload, **stamp)


def record_batch(transactions, version, new_oldest, verdicts,
                 epoch: int = -1, shard: int = -1, engine: str = "",
                 served_by: str = "", witness=(), proc=None) -> None:
    """One resolved batch from the resolution tier's TOP level (the sim
    Resolver, the ElasticResolverGroup, or a non-elastic commit server) —
    exactly once per version, so differential replay never double-applies."""
    j = _g[0]
    if j is None:
        return
    j.record(
        "batch",
        BBBatch(version=int(version), new_oldest=int(new_oldest),
                txns=tuple(transactions),
                verdicts=tuple(int(v) for v in verdicts),
                engine=engine, served_by=served_by,
                witness=tuple(witness)),
        commit_version=int(version), epoch=epoch, shard=shard, proc=proc)


def record_span(rec: Dict[str, Any]) -> None:
    """One span record past the tail sampler (core/trace.py layout)."""
    j = _g[0]
    if j is None:
        return
    trace = rec.get("Trace")
    detail = {k: v for k, v in rec.items()
              if k not in ("Name", "Trace", "Begin", "End", "Proc")}
    j.record(
        "span",
        BBSpan(name=rec.get("Name", ""), trace=trace,
               begin=float(rec.get("Begin", 0.0)),
               end=float(rec.get("End", 0.0)),
               proc=rec.get("Proc", ""), detail=detail),
        commit_version=(trace if isinstance(trace, int)
                        else int(detail.get("version") or -1)),
        trace_id=trace)


def record_health(label: str, prev: str, state: str) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("health", BBHealth(label=label, prev=prev, state=state))


def record_flight(reason: str, version, records) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("flight",
             BBFlight(reason=reason, version=int(version),
                      records=tuple(records)),
             commit_version=int(version))


def record_alert(alert: str, series: str, state: str, value,
                 detail: str) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("alert", BBAlert(alert=alert, series=series, state=state,
                              value=float(value), detail=detail))


def record_incident(inc: Dict[str, Any]) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("incident", BBIncident(
        id=int(inc.get("id", 0)), t0=float(inc.get("t0", 0.0)),
        t1=inc.get("t1"),
        alerts=tuple(a.get("name") for a in inc.get("alerts") or ()),
        windows=tuple(w.get("kind") for w in inc.get("windows") or ()),
        explained=bool(inc.get("explained")),
        explanation=inc.get("explanation"),
        summary=inc.get("summary", "")))


def record_reshard(op, phase: str, epoch: int = -1, flip_version: int = -1,
                   splits=()) -> None:
    """One phase edge of a reshard op (server/reshard.py)."""
    j = _g[0]
    if j is None:
        return
    j.record(
        "reshard",
        BBReshard(op_id=op.id, kind=op.kind, phase=phase, begin=op.begin,
                  end=op.end, epoch=epoch, flip_version=flip_version,
                  splits=tuple(splits),
                  blackout_ms=round(float(op.blackout_ms), 3),
                  donor_sids=tuple(op.donor_sids),
                  recipient_sid=op.recipient_sid, error=op.error),
        commit_version=flip_version, epoch=epoch)


def record_admission(label: str, admitted: int, rejected: int,
                     rate: float = 0.0, weights=None) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("admission",
             BBAdmission(label=label, admitted=int(admitted),
                         rejected=int(rejected), rate=float(rate),
                         weights=dict(weights or {})))


def record_heat(brief: Dict[str, Any]) -> None:
    j = _g[0]
    if j is None:
        return
    j.record("heat", BBHeat(
        conflicts=int(brief.get("conflicts", 0)),
        occupancy_frac=float(brief.get("occupancy_frac", 0.0)),
        concentration=float(brief.get("concentration", 0.0)),
        top_range=brief.get("top_range"),
        top_share=float(brief.get("top_share", 0.0))))


def record_sched(plan, version, lanes: int, pending: int,
                 epoch: int = -1) -> None:
    """One scheduling tick's decisions (pipeline/scheduler.py SchedPlan)
    stamped with the batch version the tick produced — recorded only for
    ticks that DECIDED something, so an idle scheduler writes nothing."""
    j = _g[0]
    if j is None:
        return
    d = plan.decided
    j.record(
        "sched",
        BBSched(version=int(version),
                dispatched=int(d.get("dispatch", 0)),
                deferred=int(d.get("defer", 0)),
                laned=int(d.get("lane", 0)),
                preaborted=int(d.get("preabort", 0)),
                probes=int(d.get("probe", 0)),
                forced=int(d.get("forced", 0)),
                lanes=int(lanes), pending=int(pending), epoch=int(epoch),
                preabort_ranges=tuple(plan.preabort_ranges),
                lane_ranges=tuple(plan.lane_ranges)),
        commit_version=int(version), epoch=int(epoch))


def record_window(w: Dict[str, Any]) -> None:
    """One injected fault / maintenance window (nemesis kinded record)."""
    j = _g[0]
    if j is None:
        return
    detail = {k: v for k, v in w.items() if k not in ("kind", "t0", "t1")}
    j.record("fault_window",
             BBWindow(kind=str(w.get("kind", "fault")),
                      t0=float(w.get("t0", 0.0)),
                      t1=float(w.get("t1", w.get("t0", 0.0))),
                      detail=detail))


def record_scenario(name: str, seed: int, engine_mode: str,
                    signature: Dict[str, Any]) -> None:
    """The scenario-atlas stamp (real/scenarios.py build_signature):
    written once per named campaign while the journal is still
    installed, so a bare journal directory identifies the production
    recipe — and its measured heat/abort signature — that produced it."""
    j = _g[0]
    if j is None:
        return
    j.record("scenario",
             BBScenario(
                 name=str(name), seed=int(seed),
                 engine_mode=str(engine_mode),
                 concentration=float(signature.get("concentration", 0.0)),
                 top_range=signature.get("top_range"),
                 top_share=float(signature.get("top_share", 0.0)),
                 abort_frac=float(signature.get("abort_frac", 0.0)),
                 throttle_frac=float(signature.get("throttle_frac", 0.0)),
                 witnesses=int(signature.get("witnesses", 0))))


def record_snapshot(version: int, oldest: int, entries: int,
                    nbytes: int, ms: float, path: str = "") -> None:
    """One engine-state snapshot written (fault/recovery.py): the
    journaled marker recovery + `cli recovery` anchor the floor on."""
    j = _g[0]
    if j is None:
        return
    j.record("snapshot",
             BBSnapshotEvt(version=int(version), oldest=int(oldest),
                           entries=int(entries), bytes=int(nbytes),
                           ms=round(float(ms), 3), path=path),
             commit_version=int(version))


def record_recovery(res: Dict[str, Any]) -> None:
    """One completed crash-stop recovery arc (fault/recovery.py
    RecoveryResult.as_dict()) — the record `cli recovery` renders."""
    j = _g[0]
    if j is None:
        return
    j.record("recovery",
             BBRecovery(
                 mode=str(res.get("mode", "")),
                 coverage_ok=bool(res.get("coverage_ok", True)),
                 snapshot_version=int(res.get("snapshot_version", -1)),
                 recovered_version=int(res.get("recovered_version", -1)),
                 oldest=int(res.get("oldest", 0)),
                 snapshot_entries=int(res.get("snapshot_entries", 0)),
                 replayed_batches=int(res.get("replayed_batches", 0)),
                 verdict_mismatches=int(res.get("verdict_mismatches", 0)),
                 blackout_ms=round(float(res.get("blackout_ms", 0.0)), 3),
                 progcache_hits=int(res.get("progcache_hits", 0)),
                 progcache_misses=int(res.get("progcache_misses", 0)),
                 warm_ms=round(float(res.get("warm_ms", 0.0)), 3),
                 error=res.get("error")),
             commit_version=int(res.get("recovered_version", -1)))
