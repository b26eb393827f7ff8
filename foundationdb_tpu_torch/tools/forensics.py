"""Commit forensics: causal `explain` and differential replay over the
black-box journal (core/blackbox.py).

Port of ``foundationdb_tpu/tools/forensics.py``.

The journal holds heterogeneous events — batch resolutions (with full
transactions + verdicts), retained span records, watchdog alert edges
and incidents, health transitions, flight-recorder dumps, reshard phase
arcs with epoch flips, admission/heat heartbeats, injected fault
windows — all stamped {t, commit_version, epoch, shard, trace_id}. This
module is the query side:

  * `explain(events, version)` reconstructs ONE transaction batch's full
    causal arc: admission state -> shard routing under its epoch ->
    queue wait -> dispatch -> verdict with the first-witness write (and
    the witness's own committing batch, found by scanning the journal
    backwards) -> the surrounding retry/failover arc -> overlapping
    incidents and injected fault windows — rendered by
    `render_explain()` as a deterministic narrative timeline
    (`cli explain`);
  * `diff_replay(events, v1, v2)` re-resolves the journal through the
    CLEAN serial oracle (ops/oracle.py) and diffs the persisted window's
    verdicts bit-for-bit — the campaign-end parity check turned into an
    operator tool that works on any persisted window, including across
    a reshard epoch flip (`cli blackbox replay --window v1..v2`);
  * `strict_parse(directory)` is the schema gate: every event's payload
    type must match `BLACKBOX_EVENT_REGISTRY[kind]` exactly.

Everything here is host-side and cluster-less; the oracle import is
lazy so explaining a journal never builds an engine.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import blackbox
from ..core.keyshard import _fmt_key
from ..core.types import TransactionCommitResult

_COMMITTED = int(TransactionCommitResult.COMMITTED)
_TOO_OLD = int(TransactionCommitResult.TOO_OLD)

VERDICT_NAMES = {_COMMITTED: "committed", _TOO_OLD: "too_old"}


class ForensicsError(ValueError):
    """A source that cannot be resolved to journal events (missing
    `blackbox` field, empty directory, version outside the journal)."""


# -- sources -------------------------------------------------------------------

def report_blackbox_dirs(doc: dict) -> List[Tuple[str, str]]:
    """(label, journal dir) per campaign of a report document that
    recorded one — old reports (no `blackbox` field) yield []."""
    out: List[Tuple[str, str]] = []
    for rep in doc.get("campaigns", []):
        bb = rep.get("blackbox")
        if bb and bb.get("dir"):
            out.append((f"seed {rep.get('cfg_seed')} "
                        f"[{rep.get('engine_mode')}]", bb["dir"]))
    return out


def load_source(source: Any) -> List[Tuple[str, List]]:
    """Resolve a forensics source to [(label, events)] rows.

    Accepts a live `BlackboxJournal`, a journal directory, or a campaign
    report JSON path (every campaign that recorded a journal becomes a
    row). Raises ForensicsError with an operator-speakable message when
    nothing resolves — an OLD report without the `blackbox` field says
    so instead of KeyError-ing."""
    if isinstance(source, blackbox.BlackboxJournal):
        return [("live journal", source.events())]
    s = str(source)
    if os.path.isdir(s):
        evs = blackbox.read_journal(s)
        if not evs:
            raise ForensicsError(f"no readable black-box events under {s}")
        return [(s, evs)]
    if s.endswith(".json"):
        try:
            with open(s) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise ForensicsError(f"cannot read {s}: {e}")
        rows = []
        for label, d in report_blackbox_dirs(doc):
            evs = blackbox.read_journal(d)
            if evs:
                rows.append((label, evs))
        if not rows:
            raise ForensicsError(
                f"{s} carries no black-box journal (campaigns run without "
                "--blackbox-dir / resolver_blackbox, or the journal "
                "directory is gone)")
        return rows
    raise ForensicsError(f"{s!r} is neither a journal directory nor a "
                         "campaign report JSON")


def parse_window(spec: str) -> Tuple[int, int]:
    """`v100..v2000` / `100..2000` -> (100, 2000)."""
    lo, sep, hi = spec.partition("..")
    if not sep:
        raise ForensicsError(f"bad window {spec!r} (expected v1..v2)")
    return int(lo.lstrip("v")), int(hi.lstrip("v"))


# -- the index -----------------------------------------------------------------

class JournalIndex:
    """One journal's events, grouped by kind with batches in version
    order — the read model every forensics query walks."""

    def __init__(self, events: Sequence):
        self.events = list(events)
        self.by_kind: Dict[str, List] = {}
        for e in self.events:
            self.by_kind.setdefault(e.kind, []).append(e)
        self.batches = sorted(self.by_kind.get("batch", []),
                              key=lambda e: e.payload.version)
        self.t0 = min((e.t for e in self.events), default=0.0)

    def rel(self, t: float) -> str:
        return f"t+{max(0.0, t - self.t0):.3f}s"

    def version_range(self) -> Optional[Tuple[int, int]]:
        if not self.batches:
            return None
        return (self.batches[0].payload.version,
                self.batches[-1].payload.version)

    def batch(self, version: int):
        for e in self.batches:
            if e.payload.version == version:
                return e
        return None

    def latest_before(self, kind: str, t: float):
        best = None
        for e in self.by_kind.get(kind, ()):
            if e.t <= t and (best is None or e.t >= best.t):
                best = e
        return best

    def routing_for(self, version: int):
        """(epoch, flip_version, splits) from the newest reshard `flip`
        event at or below `version`; None when the journal never
        resharded (single shard / non-elastic)."""
        best = None
        for e in self.by_kind.get("reshard", ()):
            p = e.payload
            if (p.phase == "flip" and p.flip_version >= 0
                    and p.flip_version <= version
                    and (best is None
                         or p.flip_version > best.flip_version)):
                best = p
        if best is None:
            return None
        return best.epoch, best.flip_version, list(best.splits)


# -- witness search ------------------------------------------------------------

def _ranges_overlap(rb: bytes, re_: bytes, wb: bytes, we: bytes) -> bool:
    if rb >= re_:
        re_ = rb + b"\x00"   # point/empty read: conservative point extent
    if wb >= we:
        we = wb + b"\x00"
    return rb < we and wb < re_


def find_witness(ix: JournalIndex, env, t_idx: int) -> Optional[dict]:
    """The first (most recent) committed write that convicts transaction
    `t_idx` of batch `env`: intra-batch earlier-in-batch writes first,
    then the journal's batch records scanned backwards down to the
    transaction's read snapshot. Returns the witness write's version,
    key range, and its OWN committing batch's shape — the causal other
    half of the abort."""
    batch = env.payload
    txn = batch.txns[t_idx]
    reads = list(txn.read_conflict_ranges)
    if not reads:
        return None
    # intra-batch: an earlier transaction of the SAME batch whose
    # committed write overlaps one of our reads (the oracle's
    # earlier-in-batch-wins sweep)
    for t2 in range(t_idx):
        if int(batch.verdicts[t2]) != _COMMITTED:
            continue
        for w in batch.txns[t2].write_conflict_ranges:
            for r in reads:
                if _ranges_overlap(r.begin, r.end, w.begin, w.end):
                    return {
                        "witness_version": batch.version,
                        "intra_batch": True,
                        "witness_txn": t2,
                        "key": _fmt_key(w.begin),
                        "batch_txns": len(batch.txns),
                        "batch_committed": sum(
                            1 for v in batch.verdicts
                            if int(v) == _COMMITTED),
                    }
    # history: newest earlier batch with a committed overlapping write
    # above the read snapshot
    snapshot = txn.read_snapshot
    for prior in reversed(ix.batches):
        pv = prior.payload.version
        if pv >= batch.version:
            continue
        if pv <= snapshot:
            break
        verdicts = prior.payload.verdicts
        for t2, txn2 in enumerate(prior.payload.txns):
            if int(verdicts[t2]) != _COMMITTED:
                continue
            for w in txn2.write_conflict_ranges:
                for r in reads:
                    if _ranges_overlap(r.begin, r.end, w.begin, w.end):
                        return {
                            "witness_version": pv,
                            "intra_batch": False,
                            "witness_txn": t2,
                            "key": _fmt_key(w.begin),
                            "batch_txns": len(prior.payload.txns),
                            "batch_committed": sum(
                                1 for v in verdicts
                                if int(v) == _COMMITTED),
                        }
    return None


# -- explain -------------------------------------------------------------------

def explain(events: Sequence, version: int,
            window_margin_s: float = 0.25) -> dict:
    """Reconstruct one batch version's causal arc from the journal.
    Returns a structured dict (render_explain turns it into the
    narrative); `sources` lists every signal family that joined."""
    ix = JournalIndex(events)
    env = ix.batch(version)
    if env is None:
        rng = ix.version_range()
        raise ForensicsError(
            f"no batch record at v{version}"
            + (f" (journal covers v{rng[0]}..v{rng[1]})" if rng
               else " (journal holds no batch records)"))
    batch = env.payload
    t = env.t
    sources: List[str] = ["batch"]
    #: a multi-resolver tier records one batch event per shard at each
    #: version; explain narrates the first and says so
    siblings = sum(1 for e in ix.batches if e.payload.version == version)
    info: Dict[str, Any] = {
        "version": version,
        "t": t,
        "t_rel": ix.rel(t),
        "n_txns": len(batch.txns),
        "engine": batch.engine,
        "served_by": batch.served_by,
        "new_oldest": batch.new_oldest,
        "epoch": env.epoch,
        "shard": env.shard,
        "proc": env.proc,
        "sibling_records": siblings,
    }
    # verdict split
    split = {"committed": 0, "conflicts": 0, "too_old": 0}
    for v in batch.verdicts:
        v = int(v)
        split["committed" if v == _COMMITTED else
               "too_old" if v == _TOO_OLD else "conflicts"] += 1
    info["verdicts"] = split

    # admission state at dispatch time
    adm = ix.latest_before("admission", t)
    if adm is not None:
        p = adm.payload
        offered = p.admitted + p.rejected
        info["admission"] = {
            "admitted": p.admitted, "rejected": p.rejected,
            "shed_frac": round(p.rejected / offered, 4) if offered else 0.0,
            "rate": p.rate, "t_rel": ix.rel(adm.t),
            "weights": dict(p.weights),
        }
        sources.append("admission")

    # conflict-scheduling decisions at the tick that produced this batch
    # (pipeline/scheduler.py): why transactions were deferred, laned or
    # pre-aborted before this version dispatched
    for e in ix.by_kind.get("sched", ()):
        p = e.payload
        if p.version != version:
            continue
        info["sched"] = {
            "dispatched": p.dispatched, "deferred": p.deferred,
            "laned": p.laned, "preaborted": p.preaborted,
            "probes": p.probes, "forced": p.forced,
            "lanes": p.lanes, "pending": p.pending,
            "preabort_ranges": list(p.preabort_ranges),
            "lane_ranges": list(p.lane_ranges),
        }
        sources.append("sched")
        break

    # routing under the batch's epoch
    routing = ix.routing_for(version)
    if routing is not None:
        epoch, flip_v, splits = routing
        info["routing"] = {"epoch": epoch, "flip_version": flip_v,
                           "splits": splits, "shard": env.shard}
        sources.append("routing")
    elif env.epoch >= 0:
        info["routing"] = {"epoch": env.epoch, "flip_version": None,
                           "splits": [], "shard": env.shard}
        sources.append("routing")

    # span segments: the batch's own spans + the requests it resolved
    spans = ix.by_kind.get("span", ())
    segs = {}
    requests = []
    for e in spans:
        p = e.payload
        if p.trace == version:
            segs[p.name] = round((p.end - p.begin) * 1e3, 3)
        elif (p.name == "server.commit"
              and p.detail.get("version") == version):
            requests.append({
                "rid": p.trace, "tenant": p.detail.get("tenant"),
                "err": p.detail.get("err"),
                "server_ms": round((p.end - p.begin) * 1e3, 3),
            })
    rids = {r["rid"] for r in requests}
    for e in spans:
        p = e.payload
        if p.name == "client.commit" and p.trace in rids:
            for r in requests:
                if r["rid"] == p.trace:
                    r["client_ms"] = round((p.end - p.begin) * 1e3, 3)
                    r["proc"] = p.proc
    requests.sort(key=lambda r: str(r["rid"]))
    if segs or requests:
        info["spans"] = {"segments_ms": segs, "requests": requests}
        sources.append("spans")

    # aborted transactions -> first-witness attribution; prefer the
    # device-computed samples riding the batch record, else derive the
    # witness by scanning the journal backwards
    conflicts = []
    device_wit = {w.get("txn_index"): w for w in batch.witness or ()}
    for t_idx, v in enumerate(batch.verdicts):
        if int(v) in (_COMMITTED, _TOO_OLD):
            continue
        reads = [
            _fmt_key(r.begin)
            for r in batch.txns[t_idx].read_conflict_ranges[:2]]
        row: Dict[str, Any] = {"txn": t_idx, "reads": reads}
        dw = device_wit.get(t_idx)
        if dw is not None and dw.get("witness_version") is not None:
            row["witness"] = {
                "witness_version": dw["witness_version"],
                "key": dw.get("range_begin"),
                "device_attributed": True,
            }
        else:
            w = find_witness(ix, env, t_idx)
            if w is not None:
                row["witness"] = w
        conflicts.append(row)
        if len(conflicts) >= 4:
            break
    info["conflicts"] = conflicts
    if any("witness" in c for c in conflicts):
        sources.append("witness")

    # the surrounding health / flight-recorder arc
    arc_lo, arc_hi = t - 2.0, t + 2.0
    health = [{"t_rel": ix.rel(e.t), "label": e.payload.label,
               "prev": e.payload.prev, "state": e.payload.state}
              for e in ix.by_kind.get("health", ())
              if arc_lo <= e.t <= arc_hi]
    flights = [{"t_rel": ix.rel(e.t), "reason": e.payload.reason,
                "version": e.payload.version,
                "records": len(e.payload.records)}
               for e in ix.by_kind.get("flight", ())
               if arc_lo <= e.t <= arc_hi]
    if health or flights:
        info["health"] = health
        info["flights"] = flights
        sources.append("health")

    # overlapping incidents and injected fault windows
    incidents = []
    for e in ix.by_kind.get("incident", ()):
        p = e.payload
        t1 = p.t1 if p.t1 is not None else max(t, p.t0)
        if p.t0 - window_margin_s <= t <= t1 + window_margin_s:
            incidents.append({
                "id": p.id, "t0_rel": ix.rel(p.t0),
                "t1_rel": ix.rel(t1) if p.t1 is not None else "OPEN",
                "alerts": list(p.alerts), "explained": p.explained,
                "explanation": p.explanation, "summary": p.summary})
    if incidents:
        info["incidents"] = incidents
        sources.append("incidents")
    faults = []
    for e in ix.by_kind.get("fault_window", ()):
        p = e.payload
        if p.t0 - window_margin_s <= t <= p.t1 + window_margin_s:
            faults.append({"kind": p.kind, "t0_rel": ix.rel(p.t0),
                           "t1_rel": ix.rel(p.t1)})
    if faults:
        info["faults"] = faults
        sources.append("faults")

    # keyspace-heat context nearest the batch
    heat = ix.latest_before("heat", t)
    if heat is not None:
        p = heat.payload
        info["heat"] = {"concentration": p.concentration,
                        "top_range": p.top_range, "top_share": p.top_share,
                        "occupancy_frac": p.occupancy_frac,
                        "t_rel": ix.rel(heat.t)}
        sources.append("heat")

    info["sources"] = sources
    return info


def render_explain(info: dict) -> List[str]:
    """The narrative timeline (`cli explain`) — deterministic: same
    journal bytes render the same lines."""
    out: List[str] = []
    head = (f"explain v{info['version']} — batch of {info['n_txns']} "
            f"@ {info['t_rel']}")
    tags = []
    if info.get("engine"):
        tags.append(f"engine {info['engine']}")
    if info.get("served_by"):
        tags.append(f"served {info['served_by']}")
    if info.get("proc"):
        tags.append(f"proc {info['proc']}")
    if tags:
        head += " (" + ", ".join(tags) + ")"
    if info.get("sibling_records", 1) > 1:
        head += (f" [1 of {info['sibling_records']} shard records at "
                 "this version]")
    out.append(head)
    adm = info.get("admission")
    if adm is not None:
        out.append(
            f"  admission   admitted {adm['admitted']} / shed "
            f"{adm['rejected']} ({adm['shed_frac'] * 100:.1f}% shed)"
            + (f" at rate {adm['rate']:.1f}/s" if adm["rate"] else "")
            + f"  [{adm['t_rel']}]")
    sch = info.get("sched")
    if sch is not None:
        out.append(
            f"  sched       dispatched {sch['dispatched']}, laned "
            f"{sch['laned']}, deferred {sch['deferred']}, pre-aborted "
            f"{sch['preaborted']}, probes {sch['probes']} "
            f"({sch['lanes']} lanes, {sch['pending']} queued)")
        if sch.get("preabort_ranges"):
            out.append("    pre-abort ranges: "
                       + ", ".join(sch["preabort_ranges"][:4]))
        if sch.get("lane_ranges"):
            out.append("    lane ranges: "
                       + ", ".join(sch["lane_ranges"][:4]))
    routing = info.get("routing")
    if routing is not None:
        if routing.get("flip_version") is not None:
            line = (f"  routing     epoch {routing['epoch']} "
                    f"(flip @ v{routing['flip_version']}), "
                    f"splits {routing['splits']}")
        else:
            line = f"  routing     epoch {routing['epoch']}"
        if routing.get("shard", -1) >= 0:
            line += f" -> shard {routing['shard']}"
        out.append(line)
    else:
        out.append("  routing     single shard (no epoched map recorded)")
    spans = info.get("spans") or {}
    segs = spans.get("segments_ms") or {}
    if segs:
        rendered = ", ".join(f"{name.split('.', 1)[-1]} {ms:.2f} ms"
                             for name, ms in sorted(segs.items()))
        out.append(f"  dispatch    {rendered}")
    for r in (spans.get("requests") or [])[:6]:
        out.append(
            f"  request     {r['rid']}"
            + (f" tenant={r['tenant']}" if r.get("tenant") else "")
            + (f" client {r['client_ms']:.2f} ms"
               if "client_ms" in r else "")
            + f" server {r['server_ms']:.2f} ms"
            + (f" err={r['err']}" if r.get("err") else ""))
    v = info["verdicts"]
    out.append(f"  verdicts    {v['committed']} committed, "
               f"{v['conflicts']} conflicted, {v['too_old']} too_old "
               f"(gc horizon v{info['new_oldest']})")
    for c in info.get("conflicts", []):
        line = f"    conflict  txn#{c['txn']} read {c['reads']}"
        w = c.get("witness")
        if w is not None:
            line += (f" — first witness write @ v{w['witness_version']}"
                     + (f" key {w['key']!r}" if w.get("key") else ""))
            if w.get("device_attributed"):
                line += " [device-attributed]"
            elif w.get("intra_batch"):
                line += " (same batch, earlier in order)"
            else:
                line += (f" (its batch: {w['batch_txns']} txns, "
                         f"{w['batch_committed']} committed)")
        else:
            line += " — witness outside the retained journal"
        out.append(line)
    for h in info.get("health", []):
        out.append(f"  health      {h['label']}: {h['prev']} -> "
                   f"{h['state']}  [{h['t_rel']}]")
    for f in info.get("flights", []):
        out.append(f"  flightrec   {f['reason']} @ v{f['version']} "
                   f"({f['records']} dispatch records)  [{f['t_rel']}]")
    for inc in info.get("incidents", []):
        out.append(
            f"  incident    #{inc['id']} [{inc['t0_rel']} .. "
            f"{inc['t1_rel']}] "
            + ("EXPLAINED" if inc["explained"] else "UNEXPLAINED")
            + (f" — {inc['explanation']}" if inc.get("explanation") else "")
            + (f" ({inc['summary']})" if inc.get("summary") else ""))
    for w in info.get("faults", []):
        out.append(f"  fault       {w['kind']} [{w['t0_rel']} .. "
                   f"{w['t1_rel']}] overlaps this batch")
    heat = info.get("heat")
    if heat is not None:
        out.append(
            f"  heat        concentration {heat['concentration']:.3f}"
            + (f", top {heat['top_range']!r} "
               f"{heat['top_share'] * 100:.0f}%"
               if heat.get("top_range") else "")
            + f", occupancy {heat['occupancy_frac'] * 100:.1f}%"
            + f"  [{heat['t_rel']}]")
    out.append(f"  joined      {len(info['sources'])} signal sources: "
               + ", ".join(info["sources"]))
    return out


# -- differential replay -------------------------------------------------------

def diff_replay(events: Sequence, v1: int, v2: int) -> dict:
    """Re-resolve the journal through the clean serial oracle and diff
    the persisted window's verdicts bit-for-bit. The retained prefix
    below v1 replays first (it rebuilds the oracle's observable state —
    the ResilientEngine shadow-sufficiency argument); `coverage_ok`
    reports whether the retained journal provably covers the window's
    conflict horizon (it always does when nothing rotated away).

    A journal from a MULTI-RESOLVER tier records one batch event per
    resolver per version (each resolver owns a disjoint key range and
    stamps its shard index). Such a journal replays as one stream PER
    SHARD STAMP through its own clean oracle — the per-resolver parity
    contract; a version duplicated WITHIN one shard stream (two runs
    appended into one directory) is reported as `duplicate_versions`
    instead of being double-applied into false mismatches."""
    from ..ops.oracle import OracleConflictEngine

    ix = JournalIndex(events)
    batches = ix.batches
    if not batches:
        raise ForensicsError("journal holds no batch records to replay")
    window = [e for e in batches if v1 <= e.payload.version <= v2]
    if not window:
        rng = ix.version_range()
        raise ForensicsError(
            f"no batch records in v{v1}..v{v2} "
            f"(journal covers v{rng[0]}..v{rng[1]})")
    # one replay stream per shard stamp when versions repeat across
    # stamps (the multi-resolver tier); one unified stream otherwise
    versions_unique = len({e.payload.version for e in batches}) \
        == len(batches)
    streams: Dict[int, List] = {}
    if versions_unique:
        streams[-1] = list(batches)
    else:
        for e in batches:
            streams.setdefault(e.shard, []).append(e)
    prefix = 0
    checked = 0
    duplicates: List[int] = []
    mismatches: List[dict] = []
    for shard in sorted(streams):
        stream = streams[shard]
        seen: set = set()
        oracle = OracleConflictEngine()
        for e in stream:
            p = e.payload
            if p.version > v2:
                break
            if p.version in seen:
                # same version twice in ONE stream: appended runs or a
                # corrupt journal — flag, never double-apply
                if len(duplicates) < 8:
                    duplicates.append(p.version)
                continue
            seen.add(p.version)
            want = [int(x) for x in oracle.resolve(
                list(p.txns), p.version, p.new_oldest)]
            if p.version < v1:
                prefix += 1
                continue
            checked += 1
            got = [int(x) for x in p.verdicts]
            if got != want and len(mismatches) < 8:
                mismatches.append({"version": p.version, "shard": shard,
                                   "got": got, "want": want})
            elif got != want:
                mismatches.append({"version": p.version})
    #: journal complete from birth (seq 0 retained) => replay is exact;
    #: else the earliest retained batch must predate the window's GC
    #: horizon so discarded history is below the too-old gate anyway
    complete = bool(events) and min(e.seq for e in events) == 0
    coverage_ok = complete or (
        batches[0].payload.version <= window[0].payload.new_oldest)
    return {
        "v1": v1, "v2": v2,
        "prefix_batches": prefix,
        "window_batches": checked,
        "shard_streams": sorted(streams),
        "duplicate_versions": duplicates,
        "mismatches": len(mismatches),
        "mismatch_detail": mismatches[:8],
        "epochs": sorted({e.epoch for e in window}),
        "complete_journal": complete,
        "coverage_ok": coverage_ok,
    }


# -- schema gate ---------------------------------------------------------------

def strict_parse(directory: str) -> dict:
    """Load every readable event and enforce the CLOSED schema: each
    kind must be in BLACKBOX_EVENT_REGISTRY and its payload must be
    exactly the registered record type. Returns per-kind counts."""
    events = blackbox.read_journal(directory)
    if not events:
        raise ForensicsError(f"no readable black-box events under "
                             f"{directory}")
    counts: Dict[str, int] = {}
    last_seq = None
    for e in events:
        cls = blackbox.BLACKBOX_EVENT_REGISTRY.get(e.kind)
        if cls is None:
            raise ForensicsError(
                f"event seq {e.seq} has unregistered kind {e.kind!r}")
        if type(e.payload) is not cls:
            raise ForensicsError(
                f"event seq {e.seq} kind {e.kind!r} payload is "
                f"{type(e.payload).__name__}, registry says {cls.__name__}")
        if last_seq is not None and e.seq != last_seq + 1:
            raise ForensicsError(
                f"sequence gap inside retained journal: {last_seq} -> "
                f"{e.seq}")
        last_seq = e.seq
        counts[e.kind] = counts.get(e.kind, 0) + 1
    return counts


def summarize(label: str, events: Sequence) -> List[str]:
    """`cli blackbox` rendering: what one journal holds."""
    ix = JournalIndex(events)
    kinds = {k: len(v) for k, v in sorted(ix.by_kind.items())}
    rng = ix.version_range()
    span = (f"v{rng[0]}..v{rng[1]}" if rng else "no batch records")
    seqs = [e.seq for e in ix.events]
    out = [f"  {label}: {len(ix.events)} events ({span})"
           + ("" if not seqs or min(seqs) == 0
              else f" — rotated (earliest retained seq {min(seqs)})")]
    for k, n in kinds.items():
        out.append(f"    {k:<14} {n}")
    flips = [e.payload for e in ix.by_kind.get("reshard", ())
             if e.payload.phase == "flip"]
    for p in flips:
        out.append(f"    epoch flip    e{p.epoch} @ v{p.flip_version} "
                   f"splits {list(p.splits)}")
    return out
