"""Range history handoff: move a key range's committed write history
between supervised engines without losing a verdict.

Port of ``foundationdb_tpu/fault/handoff.py``. `run_slice` reads a tiered
port engine's run planes off the card (a device-to-host copy, outside
any dispatch).

The donor side of an online reshard (server/reshard.py) must hand the
recipient everything that can still decide a verdict for the moving
range. The ResilientEngine's shadow (fault/resilient.py) is exactly that
window: one (version, committed write ranges, new_oldest) entry per
resolved batch, trimmed to version >= the GC horizon — the same
sufficiency argument that makes failover rebuilds bit-identical (any
read passing the too-old gate has snapshot >= oldest, so writes below
the horizon can never conflict) makes a RANGE-CLIPPED slice of the
shadow sufficient for the moving range.

Transfer happens in two stages, the classic live-migration shape:

  * pre-copy (unfrozen): the slice as of a version watermark is
    COALESCED to the effective interval map (key -> last write version,
    restricted to the range — a hot range overwrites the same keys over
    and over, so the coalesced form is bounded by distinct keys, not by
    history length) and replayed into the recipient as synthetic
    write-only transactions, one batch per distinct version in ascending
    order. The donor keeps serving; writes landing after the watermark
    are the next round's delta.
  * delta (frozen): once the range is frozen the few entries above the
    final watermark replay raw — this is the only part inside the
    blackout, which is what keeps the per-range unavailability under
    `reshard_blackout_budget_ms`.

Replaying through the recipient's ResilientEngine (not its raw device)
is the point: the synthetic batches land in the recipient's OWN shadow
and journal, so a later failover, probe or re-warm of the recipient
rebuilds WITH the adopted history, and the campaign's clean-oracle
journal replay covers the handoff batches like any others. Write-only
transactions commit unconditionally (no reads -> no conflicts, no
too-old), so adoption can never flip a verdict.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.types import CommitTransaction, Key, KeyRange, Version
from ..ops.oracle import VersionIntervalMap

#: (version, ((begin, end), ...)) — one replayable write-history batch
HistoryBatch = Tuple[Version, Tuple[Tuple[Key, Key], ...]]

#: history-maintenance span segments, on their own timeline like the
#: reshard protocol arcs (registered with the fdbtpu-lint span-registry
#: rule; docs/static_analysis.md#span-registry)
HISTORY_SEGMENTS = (
    "snapshot",   # device run-plane readback (history_run_snapshots)
    "slice",      # run-interval decode + range clip + version regroup
)


def _unwrap(engine):
    unwrap = getattr(engine, "_rewarm_engine", None)
    return unwrap() if unwrap is not None else engine


def _merge_epoch(engine) -> Optional[int]:
    """Cumulative compaction count the donor's heat layer has observed
    (KeyRangeHeatAggregator.history_merges_total) — the monotone epoch
    an incremental run_slice chain is valid within. None when the donor
    runs without the heat layer (no epoch -> no incremental proof)."""
    heat = getattr(engine, "heat", None)
    total = getattr(heat, "history_merges_total", None)
    return int(total) if total is not None else None


def run_watermarks(engine) -> Optional[Tuple[List[int], Optional[int]]]:
    """(per-shard nruns vector, merge epoch) seeding an incremental
    run_slice chain; None when the donor does not serve the tiered
    path. Capture BEFORE reading the shadow for the same round: a batch
    landing in between is then re-fetched (idempotent duplicate), never
    skipped."""
    engine = _unwrap(engine)
    fn = getattr(engine, "history_run_snapshots", None)
    if fn is None:
        return None
    snaps = fn(since_runs=None)
    if snaps is None:
        return None
    return [int(s["nruns"]) for s in snaps], _merge_epoch(engine)


def run_slice(engine, begin: Key, end: Optional[Key],
              since_runs: Optional[List[int]] = None,
              since_epoch: Optional[int] = None) -> Optional[dict]:
    """Pre-copy source straight off a tiered donor's device run planes —
    the O(delta) sibling of shadow_slice (docs/perf.md "Incremental
    history maintenance").

    A tiered engine's un-merged sorted runs ARE the committed-write
    history since the last compaction, so a repeat pre-copy round only
    needs the runs appended after the previous round's watermark:
    `since_runs` is the per-shard nruns vector returned by the prior
    call; pass None for the first round (all active runs). Rows come
    back range-clipped and regrouped into ascending-version
    HistoryBatch entries, ready for replay_slice.

    Returns None when the donor cannot serve the path — monolithic
    structure, no device-state accessor, or a run row whose endpoint
    was window-truncated (the exact byte key is not recoverable from
    the device image; the host shadow has it) — callers then fall back
    to shadow_slice, which is always sufficient. Otherwise returns
    {"entries": [HistoryBatch...], "watermarks": [per-shard nruns],
    "epoch": Optional[int], "resync": bool} — resync=True means a
    compaction consumed runs below a caller watermark (the LSM manifest
    contract: the delta chain broke, redo a full pre-copy with
    since_runs=None).

    `since_epoch` is the `epoch` of the prior round (run_watermarks'
    second element for a fresh chain). It closes the ABA hole the nruns
    vector alone cannot see: a merge can absorb an uncopied run and
    subsequent appends can push nruns back past the caller's watermark,
    so pass the epoch whenever the chain must be PROVEN unbroken —
    any intervening merge (or a donor without the heat layer to count
    them) then flags resync."""
    engine = _unwrap(engine)        # supervised donor: reach the device
    fn = getattr(engine, "history_run_snapshots", None)
    if fn is None:
        return None
    from ..core.trace import g_spans, span_event, span_now

    spans_on = g_spans.enabled
    t0 = span_now()
    snaps = fn(since_runs=since_runs)
    if snaps is None:
        return None
    t_snap = span_now()
    from ..ops import conflict_kernel as ck
    from ..ops import keypack

    cfg = engine.cfg
    kw = cfg.key_words
    kb = keypack.max_key_bytes(kw)
    base = int(getattr(engine, "base", 0))
    epoch = _merge_epoch(engine)
    resync = since_epoch is not None and (epoch is None
                                          or epoch != since_epoch)
    watermarks: List[int] = []
    by_version: Dict[Version, List[Tuple[Key, Key]]] = {}
    for s, snap in enumerate(snaps):
        watermarks.append(int(snap["nruns"]))
        if since_runs is not None and int(snap["nruns"]) < since_runs[s]:
            resync = True
        for kb_row, ke_row, rel_v in ck.run_intervals(snap):
            if int(kb_row[kw]) > kb or int(ke_row[kw]) > kb:
                return None     # window-truncated endpoint: shadow has it
            b = keypack.unpack_key(kb_row, kw)
            e = keypack.unpack_key(ke_row, kw)
            c = clip_range(b, e, begin, end)
            if c is not None:
                by_version.setdefault(base + rel_v, []).append(c)
    entries = [(v, tuple(sorted(by_version[v]))) for v in sorted(by_version)]
    if spans_on:
        span_event("history.snapshot", base, t0, t_snap,
                   shards=len(snaps))
        span_event("history.slice", base, t_snap, span_now(),
                   entries=len(entries), resync=resync)
    return {"entries": entries, "watermarks": watermarks, "epoch": epoch,
            "resync": resync}


def clip_range(b: Key, e: Key, begin: Key,
               end: Optional[Key]) -> Optional[Tuple[Key, Key]]:
    """Concrete [b, e) intersected with the shard span [begin, end);
    None when empty. A `None` span end means +inf (the last span)."""
    cb = max(b, begin)
    ce = e if end is None else min(e, end)
    return (cb, ce) if cb < ce else None


def shadow_slice(engine, begin: Key, end: Optional[Key],
                 min_version: Version = 0) -> List[HistoryBatch]:
    """The donor ResilientEngine's shadow entries above `min_version`,
    clipped to [begin, end); empty clips drop. Entries come back in
    shadow (= resolution) order."""
    out: List[HistoryBatch] = []
    for version, writes, _new_oldest in getattr(engine, "_shadow", ()):
        if version <= min_version:
            continue
        clipped = []
        for b, e in writes:
            c = clip_range(b, e, begin, end)
            if c is not None:
                clipped.append(c)
        if clipped:
            out.append((version, tuple(clipped)))
    return out


def coalesce(entries: Sequence[HistoryBatch],
             begin: Key, end: Optional[Key]) -> List[HistoryBatch]:
    """Entries -> the EFFECTIVE interval map restricted to [begin, end),
    re-expressed as one write-only batch per distinct surviving version,
    ascending. Observable-state equivalent to replaying every entry:
    later writes overwrite earlier ones key-by-key exactly as the
    interval map records, and sub-horizon residue was already trimmed
    from the shadow. A hot range that overwrote the same keys thousands
    of times coalesces to a handful of intervals — this is what keeps
    pre-copy (and with it the frozen delta) small."""
    if not entries:
        return []
    m = VersionIntervalMap(0)
    for version, writes in entries:
        for b, e in writes:
            if e is None:
                e = b"\xff\xff\xff\xff\xff\xff"
            m.write(b, e, version)
    by_version: Dict[Version, List[Tuple[Key, Key]]] = {}
    keys, vers = m.keys, m.vers
    for i, v in enumerate(vers):
        if v <= 0:
            continue
        b = keys[i]
        e = keys[i + 1] if i + 1 < len(keys) else b"\xff\xff\xff\xff\xff\xff"
        rows = by_version.setdefault(v, [])
        # merge adjacency within one version: the map splits intervals at
        # every historical boundary; re-fusing keeps batches minimal
        if rows and rows[-1][1] == b:
            rows[-1] = (rows[-1][0], e)
        else:
            rows.append((b, e))
    return [(v, tuple(by_version[v])) for v in sorted(by_version)]


async def replay_slice(recipient, entries: Sequence[HistoryBatch]) -> int:
    """Adopt `entries` into the recipient supervised engine: one
    synthetic write-only transaction per batch, resolved at the entry's
    own version (write versions must be preserved exactly — quantizing
    them upward would manufacture conflicts for snapshots in between).
    new_oldest rides as 0 so adoption never advances the recipient's
    too-old gate. Returns the number of batches replayed."""
    n = 0
    for version, writes in entries:
        txn = CommitTransaction(
            read_snapshot=version,
            write_conflict_ranges=[KeyRange(b, e) for b, e in writes])
        r = recipient.resolve([txn], version, 0)
        if hasattr(r, "__await__"):
            await r
        n += 1
    return n


def last_shadow_version(engine) -> Version:
    """The donor's newest shadow version — the pre-copy watermark."""
    shadow = getattr(engine, "_shadow", None)
    if not shadow:
        return 0
    return max(entry[0] for entry in shadow)


def migrate_ewmas(src_batcher, dst_batcher) -> int:
    """Carry a donor batcher's observed per-(bucket, search-mode,
    dispatch-mode) latency EWMAs onto the recipient so the moved range's
    batch sizing starts from the donor's measurements instead of
    re-learning from cold (pipeline/resolver_pipeline.BudgetBatcher).
    Keys the recipient has already observed win. Returns entries copied."""
    if src_batcher is None or dst_batcher is None:
        return 0
    copied = 0
    for key, ms in src_batcher.ewma_ms.items():
        if key not in dst_batcher.ewma_ms:
            dst_batcher.ewma_ms[key] = float(ms)
            copied += 1
    return copied
