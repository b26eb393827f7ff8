"""Decaying keyspace-heat aggregator: the host half of the resolver-state
observability layer.

Port of ``foundationdb_tpu/core/heatmap.py``: the same class, read model
and knob reads (`resolver_heat_buckets`, `resolver_heat_decay`,
`resolver_heat_split_shards`, `resolver_heat_split_hysteresis`). The device
side (`ops/conflict_kernel.heat_of`) emits one small packed
aggregate per resolved batch — a read/write/conflict histogram over B
bucket-boundary keys sampled from the interval table, verdict counts,
table occupancy, GC-reclaimed rows, and a first-witness abort attribution
per transaction. This module merges those aggregates across batches into
a decayed per-key-range weight map and answers the questions the device
cannot:

  * where in the keyspace do conflicts concentrate (`hot_ranges`,
    `concentration` — a normalized Herfindahl index of the load split);
  * how full is the history table and how hard is GC working
    (`occupancy`, headroom, reclaimed totals);
  * where should key-range shard boundaries go (`split_points` — the
    measured load split that key-range sharding needs).

Merging is keyed by the decoded boundary BEGIN key, not the bucket index:
the device's bucket grid shifts as the table evolves (and differs per
sub-shard), but a key is a key — so step, sub-sharded, mesh and loop
engines all merge through the same path, and multi-shard aggregates
interleave correctly.

Bit-safety: the aggregator only ever consumes outputs; it can never touch
a verdict. Everything here is plain numpy/python, so the disabled path
(heat_buckets = 0) costs nothing and imports nothing device-side.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: heat histogram lanes (must match ops/conflict_kernel.HEAT_HIST_LANES)
LANE_READS, LANE_WRITES, LANE_CONFLICTS = 0, 1, 2
#: counts lanes (ops/conflict_kernel.HEAT_COUNT_LANES)
C_COMMITTED, C_CONFLICTS, C_TOO_OLD, C_RECLAIMED = 0, 1, 2, 3

# the one boundary-key renderer (printable ASCII as text, else 0x-hex),
# shared with the shard map's report dicts
from .keyshard import _fmt_key  # noqa: E402


def _unpack_key(row: np.ndarray, key_words: int) -> bytes:
    """Packed (words..., length) row -> key bytes (keypack inverse,
    numpy-only so the aggregator never imports the ops package)."""
    length = int(row[key_words])
    raw = np.ascontiguousarray(row[:key_words], dtype=np.uint32) \
        .astype(">u4").tobytes()
    return raw[: min(length, 4 * key_words)]


def _unpack_keys(bounds: np.ndarray, key_words: int) -> List[bytes]:
    """All B boundary rows decoded in one vectorized pass — this runs on
    the serving force/drain path once per merged chunk, so no per-word
    Python byte juggling."""
    kw4 = 4 * key_words
    raw = np.ascontiguousarray(bounds[:, :key_words], dtype=np.uint32) \
        .astype(">u4").tobytes()
    lens = np.minimum(bounds[:, key_words].astype(np.int64), kw4)
    return [raw[b * kw4: b * kw4 + int(lens[b])]
            for b in range(bounds.shape[0])]


class KeyRangeHeatAggregator:
    """Decayed per-key-range weights merged from per-batch device heat
    aggregates. One instance per engine (ops/host_engine.py constructs it
    when the config's heat_buckets > 0); thread-safe enough for the
    pipeline's pack/force interleave because merge() and readers only
    touch python dicts under the GIL and never iterate while mutating."""

    #: retained key-range entries (boundary grids shift as the table
    #: evolves; pruning keeps the map bounded without losing hot ranges)
    MAX_RANGES = 512
    #: retained first-witness attribution samples
    MAX_ATTRIBUTION = 64

    def __init__(self, key_words: int, capacity: int,
                 buckets: int, decay: float = 0.98):
        self.key_words = int(key_words)
        self.capacity = int(capacity)
        self.buckets = int(buckets)
        #: per-merge multiplicative decay of every existing weight — the
        #: `resolver_heat_decay` knob; 1.0 = lifetime totals, smaller =
        #: faster forgetting (a diurnal hot-spot shift stops dominating
        #: split planning after ~1/(1-decay) batches)
        self.decay = float(decay)
        #: begin-key bytes -> float64 [reads, writes, conflicts]
        self._w: Dict[bytes, np.ndarray] = {}
        self.batches = 0
        self.occupancy = 0
        self.gc_reclaimed_total = 0
        self.verdict_totals = {"committed": 0, "conflicts": 0, "too_old": 0}
        # tiered-history run accounting (docs/perf.md "Incremental history
        # maintenance"): mirrored host-side from the heat aggregate's
        # `runs` leaf — the live run-stack depth each batch leaves behind.
        # Appends/merges are derived from per-shard depth TRANSITIONS
        # (depth up by d = d appends; depth down = one lazy merge
        # compacted the stack, and the post-merge depth is the appends it
        # was left with), so the counters are exact with zero device
        # syncs. Monolithic engines never emit the leaf; everything stays 0.
        self.history_appends_total = 0
        self.history_merges_total = 0
        self.history_runs_live = 0
        self.history_run_rows_live = 0
        self._hist_nruns: Dict[int, int] = {}
        #: recent first-witness abort attributions: which prior write
        #: (version) killed a transaction, and in which key range
        self.attribution: deque = deque(maxlen=self.MAX_ATTRIBUTION)
        #: consumable copy of the witness stream for drain_witnesses():
        #: `attribution` above is a DISPLAY ring (cli heat, blackbox,
        #: attribution_for) that readers peek without consuming; a second
        #: reader that also peeked it would double-count samples, so
        #: consumers (the conflict scheduler) get their own queue that
        #: drains atomically. Raw begin-key bytes, not formatted.
        self._pending_witnesses: deque = deque(maxlen=4 * self.MAX_ATTRIBUTION)
        #: last ADOPTED split points (split-point hysteresis: a fresh
        #: equal-load derivation replaces these only when it improves the
        #: measured imbalance by at least the hysteresis knob — two
        #: adjacent scrapes of a stationary stream must not flap the
        #: resharding controller by one bucket)
        self._last_splits: Optional[List[bytes]] = None

    # -- merging -------------------------------------------------------------
    def merge(self, heat: Dict[str, np.ndarray], base: int = 0,
              version: Optional[int] = None) -> None:
        """Fold ONE single-shard batch's device heat aggregate (unstacked
        leaves, as emitted by resolve_step) into the decayed map. `base`
        is the engine's version base (device versions are base-relative);
        `version` is the batch's commit version when the caller knows it
        (attribution samples carry it)."""
        self.merge_shards([heat], base=base, version=version)

    def merge_shards(self, per_shard: Sequence[Dict[str, np.ndarray]],
                     base: int = 0, version: Optional[int] = None) -> None:
        """Fold ONE batch resolved across `len(per_shard)` key-range
        shards (sub-sharded / mesh engines: each shard's own table
        delimits its buckets, all for the SAME transactions). The
        histogram merges per shard keyed by boundary key, but the
        batch-GLOBAL lanes are counted once: committed/conflicts/too_old
        are replicated across shards (the stacked-batch contract), decay
        ticks once per batch, and occupancy SUMS the shard tables (the
        capacity passed at construction is the summed capacity too).
        gc_reclaimed is shard-local and sums."""
        self.batches += 1
        counts0 = np.asarray(per_shard[0]["counts"], dtype=np.int64)
        self.verdict_totals["committed"] += int(counts0[C_COMMITTED])
        self.verdict_totals["conflicts"] += int(counts0[C_CONFLICTS])
        self.verdict_totals["too_old"] += int(counts0[C_TOO_OLD])
        self.occupancy = sum(int(np.asarray(h["occupancy"]))
                             for h in per_shard)
        if "run_rows" in per_shard[0]:
            self.history_run_rows_live = sum(
                int(np.asarray(h["run_rows"])) for h in per_shard)
        if self.decay < 1.0 and self._w:
            for w in self._w.values():
                w *= self.decay
        samples = 0
        for si, heat in enumerate(per_shard):
            bounds = np.asarray(heat["bounds"])
            hist = np.asarray(heat["hist"], dtype=np.int64)
            self.gc_reclaimed_total += int(
                np.asarray(heat["counts"], dtype=np.int64)[C_RECLAIMED])
            if "runs" in heat:
                self._note_history_runs(si, int(np.asarray(heat["runs"])))
            keys = _unpack_keys(bounds, self.key_words)
            for b, key in enumerate(keys):
                row = hist[b]
                if not row.any():
                    continue
                w = self._w.get(key)
                if w is None:
                    w = np.zeros((3,), np.float64)
                    self._w[key] = w
                w += row
            # first-witness attribution samples (a handful per batch; a
            # multi-shard txn may witness on the shard that owns the row)
            wb = np.asarray(heat["wit_bucket"])
            if wb.size and samples < 4:
                aborted = np.flatnonzero(wb >= 0)
                wv = np.asarray(heat["wit_ver"])
                for t in aborted[: 4 - samples]:
                    samples += 1
                    self.attribution.append({
                        "txn_index": int(t),
                        "version": version,
                        "witness_version": int(wv[t]) + base,
                        "range_begin": _fmt_key(keys[int(wb[t])]),
                    })
                    self._pending_witnesses.append({
                        "version": version,
                        "witness_version": int(wv[t]) + base,
                        "range_begin": keys[int(wb[t])],
                    })
        self._prune()

    def _note_history_runs(self, shard: int, nruns: int) -> None:
        """Fold one shard's post-apply run-stack depth into the derived
        append/merge counters (see __init__). `nruns == 0` with a prior
        nonzero depth is a zero-initialized plane (a loop slot that never
        ran a batch), not a merge — real merges always fire under a batch
        that then appends, leaving depth >= 1."""
        old = self._hist_nruns.get(shard, 0)
        if nruns > old:
            self.history_appends_total += nruns - old
        elif 0 < nruns < old:
            # the stack can only SHRINK through a lazy merge: the slots
            # were full at apply time, the merge retired them into the
            # base table, and the depth left behind is the batch's own
            # appends (1 on the device path). Equal depth is a
            # write-free batch — no append, no merge.
            self.history_merges_total += 1
            self.history_appends_total += nruns
        else:
            return  # equal depth (no writes) or a zero-initialized plane
        self._hist_nruns[shard] = nruns
        self.history_runs_live = sum(self._hist_nruns.values())

    def history_snapshot(self) -> Dict[str, int]:
        """The tiered-history counter fragment (host_engine
        history_stats_snapshot merges it under the structure identity)."""
        return {
            "appends": self.history_appends_total,
            "merges": self.history_merges_total,
            "runs_live": self.history_runs_live,
            "run_rows_live": self.history_run_rows_live,
        }

    def observe_batch(self, transactions, verdicts,
                      version: Optional[int] = None) -> None:
        """Host-fed merge path: fold ONE resolved batch's conflict ranges
        directly into the decayed map, keyed by each range's begin key.

        The device path (`merge`/`merge_shards`) rides the resolve step's
        packed aggregate and its table-sampled bucket grid; this path
        serves engines without the device layer (the CPU oracle, an
        elastic group of supervised engines — server/reshard.py) from the
        transactions the host already holds. Same read model either way:
        hot_ranges / concentration / split_points answer identically, the
        grid is just the observed range-begin keys instead of sampled
        table boundaries. Reads land in the reads lane; committed writes
        in the writes lane; a conflicted transaction's read begins in the
        conflicts lane (where the contention actually bit)."""
        from .types import TransactionCommitResult

        self.batches += 1
        committed = int(TransactionCommitResult.COMMITTED)
        too_old = int(TransactionCommitResult.TOO_OLD)
        if self.decay < 1.0 and self._w:
            for w in self._w.values():
                w *= self.decay

        def lane(key: bytes, ln: int, amount: float = 1.0) -> None:
            w = self._w.get(key)
            if w is None:
                w = self._w[key] = np.zeros((3,), np.float64)
            w[ln] += amount

        samples = 0
        for t, txn in enumerate(transactions):
            v = int(verdicts[t])
            if v == committed:
                self.verdict_totals["committed"] += 1
            elif v == too_old:
                self.verdict_totals["too_old"] += 1
            else:
                self.verdict_totals["conflicts"] += 1
            for r in txn.read_conflict_ranges:
                lane(r.begin, LANE_READS)
                if v != committed and v != too_old:
                    lane(r.begin, LANE_CONFLICTS)
            if v == committed:
                for r in txn.write_conflict_ranges:
                    lane(r.begin, LANE_WRITES)
            elif (v != too_old and version is not None and samples < 4
                  and txn.read_conflict_ranges):
                # sampled abort attribution, the host-fed analog of the
                # device path's first-witness ring: the host doesn't know
                # WHICH prior write convicted, but the aborted range and
                # batch version still place the contention
                samples += 1
                self.attribution.append({
                    "txn_index": t,
                    "version": int(version),
                    "witness_version": None,
                    "range_begin": _fmt_key(
                        txn.read_conflict_ranges[0].begin),
                })
                self._pending_witnesses.append({
                    "version": int(version),
                    "witness_version": None,
                    "range_begin": txn.read_conflict_ranges[0].begin,
                })
        self._prune()

    def drain_witnesses(self) -> List[dict]:
        """Consume the pending first-witness samples atomically and return
        them. `attribution` is a peek-only display ring shared by `cli
        heat`, the black-box batch records and `attribution_for`; any
        consumer that also peeked it would double-count samples it saw on
        a previous read. Consumers (the conflict scheduler) call this
        instead: each sample is returned exactly once, with the RAW begin
        key bytes (`range_begin`) so the consumer can key its own maps.
        Single swap-then-read, so a merge interleaved from the pipeline's
        pack/force never splits a sample between two drains."""
        pending, self._pending_witnesses = (
            self._pending_witnesses,
            deque(maxlen=self._pending_witnesses.maxlen))
        return list(pending)

    def attribution_for(self, version: int) -> List[dict]:
        """The retained first-witness attribution samples of ONE batch
        version — what the black-box journal attaches to that batch's
        record (core/blackbox.py) and `cli explain` leads its verdict
        line with."""
        return [dict(a) for a in self.attribution
                if a.get("version") == version]

    def reset_weights(self) -> None:
        """Drop the accumulated range weights and attribution samples
        (verdict/occupancy totals stay). Useful after a warm-up phase:
        while the table is still filling, the bucket grid shifts batch to
        batch and spreads one key's load across neighboring begin keys —
        resetting once the keyspace is populated measures the steady
        state on a stationary grid."""
        self._w.clear()
        self.attribution.clear()
        self._pending_witnesses.clear()
        self._last_splits = None

    def _prune(self) -> None:
        if len(self._w) <= self.MAX_RANGES:
            return
        ranked = sorted(self._w.items(), key=lambda kv: -float(kv[1].sum()))
        self._w = dict(ranked[: self.MAX_RANGES])

    # -- read model ----------------------------------------------------------
    def _sorted_items(self) -> List[Tuple[bytes, np.ndarray]]:
        return sorted(self._w.items(), key=lambda kv: kv[0])

    def total_load(self) -> float:
        """The split-planning load measure: write rows + conflict rows
        (conflicts weigh where contention actually bites, not just where
        bytes land)."""
        if not self._w:
            return 0.0
        return float(sum(w[LANE_WRITES] + w[LANE_CONFLICTS]
                         for w in self._w.values()))

    def hot_ranges(self, top_n: int = 8) -> List[dict]:
        """Top-N key ranges by write+conflict load, with each range's end
        key (the next boundary in key order; None = +inf)."""
        items = self._sorted_items()
        total = self.total_load() or 1.0
        scored = []
        for i, (key, w) in enumerate(items):
            end = items[i + 1][0] if i + 1 < len(items) else None
            load = float(w[LANE_WRITES] + w[LANE_CONFLICTS])
            scored.append({
                "begin": _fmt_key(key),
                "end": _fmt_key(end) if end is not None else None,
                "reads": round(float(w[LANE_READS]), 1),
                "writes": round(float(w[LANE_WRITES]), 1),
                "conflicts": round(float(w[LANE_CONFLICTS]), 1),
                "share": round(load / total, 4),
            })
        scored.sort(key=lambda r: -r["share"])
        return scored[:top_n]

    def concentration_defined(self) -> bool:
        """Whether concentration() has a value: the load split must span
        at least two ranges and carry load. Below that the index is
        undefined and concentration() returns 0, which would read as
        "perfectly even" (a cold device grid puts all early load in one
        range)."""
        if len(self._w) < 2:
            return False
        return any(float(w[LANE_WRITES] + w[LANE_CONFLICTS]) > 0 for w in self._w.values())

    def concentration(self) -> float:
        """Normalized Herfindahl index of the write+conflict load split
        across ranges: 0 = perfectly even, 1 = all load in one range.
        Monotone in workload skew — the `conflict_heat` bench asserts it
        tracks the fleet's Zipf s."""
        loads = np.array([w[LANE_WRITES] + w[LANE_CONFLICTS]
                          for w in self._w.values()], np.float64)
        n = loads.size
        total = float(loads.sum())
        if n <= 1 or total <= 0:
            return 0.0
        f = loads / total
        hhi = float(np.sum(f * f))
        return max(0.0, (hhi - 1.0 / n) / (1.0 - 1.0 / n))

    def split_points(self, shards: Optional[int] = None) -> List[bytes]:
        """`shards - 1` suggested key-range split keys that equalize the
        measured write+conflict load — the direct input to multi-chip
        key-range sharding (ROADMAP item 1). Split i is the first range
        boundary whose cumulative load reaches i/shards of the total, so
        per-shard imbalance is bounded by the heaviest single bucket's
        share (finer device bucket grids tighten it)."""
        if shards is None:
            shards = self.default_split_shards()
        items = self._sorted_items()
        if not items or shards < 2:
            return []
        loads = np.array([w[LANE_WRITES] + w[LANE_CONFLICTS]
                          for _k, w in items], np.float64)
        total = float(loads.sum())
        if total <= 0:
            return []
        cum = np.cumsum(loads)
        out: List[bytes] = []
        for i in range(1, shards):
            j = int(np.searchsorted(cum, total * i / shards))
            j = min(j + 1, len(items) - 1)   # split at the NEXT begin key
            key = items[j][0]
            if not out or key > out[-1]:
                out.append(key)
        # Split-point hysteresis (the `resolver_heat_split_hysteresis`
        # knob): the equal-load derivation above re-runs on the DECAYED
        # weights every call, so two adjacent scrapes of a stationary
        # stream can disagree by one bucket — enough to flap an online
        # resharding controller between two near-equal plans. Keep the
        # last adopted splits unless the fresh candidate improves the
        # measured per-shard imbalance by at least the knob.
        last = self._last_splits
        if (last is not None and last != out
                and len(last) == len(out)):
            imb_last = self._imbalance(self.split_balance(shards, last))
            imb_new = self._imbalance(self.split_balance(shards, out))
            if imb_last - imb_new < self._split_hysteresis():
                return list(last)
        self._last_splits = list(out)
        return out

    def split_key_within(self, begin: bytes,
                         end: Optional[bytes]) -> Optional[bytes]:
        """The measured equal-load midpoint key STRICTLY inside span
        [begin, end) — where an online split of that span should cut
        (server/reshard.py). None when the span's load sits in a single
        retained bucket (nothing to split on)."""
        items = [(k, w) for k, w in self._sorted_items()
                 if k >= begin and (end is None or k < end)]
        if len(items) < 2:
            return None
        loads = [float(w[LANE_WRITES] + w[LANE_CONFLICTS]) for _k, w in items]
        total = sum(loads)
        if total <= 0:
            return None
        acc = 0.0
        for i, (k, _w) in enumerate(items):
            acc += loads[i]
            if acc >= total / 2 and i + 1 < len(items):
                key = items[i + 1][0]
                if key > begin and (end is None or key < end):
                    return key
                return None
        return None

    @staticmethod
    def _imbalance(fracs: Sequence[float]) -> float:
        """Worst per-shard deviation from the equal-load ideal."""
        if not fracs:
            return 0.0
        ideal = 1.0 / len(fracs)
        return max(abs(f - ideal) for f in fracs)

    @staticmethod
    def _split_hysteresis() -> float:
        from .knobs import SERVER_KNOBS

        return float(getattr(SERVER_KNOBS,
                             "resolver_heat_split_hysteresis", 0.05))

    def split_balance(self, shards: Optional[int] = None,
                      splits: Optional[Sequence[bytes]] = None) -> List[float]:
        """Measured load fraction per shard under `splits` (default: the
        suggested split_points) — what the heat-smoke/bench assert stays
        within tolerance of 1/shards."""
        if shards is None:
            shards = self.default_split_shards()
        if splits is None:
            splits = self.split_points(shards)
        items = self._sorted_items()
        total = self.total_load()
        if not items or total <= 0:
            return []
        frac = [0.0] * (len(splits) + 1)
        for key, w in items:
            s = 0
            for sp in splits:
                if key >= sp:
                    s += 1
                else:
                    break
            frac[s] += float(w[LANE_WRITES] + w[LANE_CONFLICTS]) / total
        return frac

    @staticmethod
    def default_split_shards() -> int:
        from .knobs import SERVER_KNOBS

        return int(getattr(SERVER_KNOBS, "resolver_heat_split_shards", 8))

    # -- snapshots -----------------------------------------------------------
    def occupancy_frac(self) -> float:
        return self.occupancy / self.capacity if self.capacity else 0.0

    def brief(self) -> dict:
        """Tiny span/flight-record attachment: enough to say whether a
        slow or quarantined batch ran under hot-key pressure. Runs on the
        supervisor's per-batch path, so it is one argmax pass over the
        raw weights — no sorting, and only the winning key is formatted
        (hot_ranges would format every retained range)."""
        best_key, best_load, total = None, 0.0, 0.0
        for key, w in self._w.items():
            load = float(w[LANE_WRITES] + w[LANE_CONFLICTS])
            total += load
            if load > best_load:
                best_load, best_key = load, key
        return {
            "conflicts": self.verdict_totals["conflicts"],
            "occupancy_frac": round(self.occupancy_frac(), 4),
            "concentration": round(self.concentration(), 4),
            "top_range": _fmt_key(best_key) if best_key is not None else None,
            "top_share": round(best_load / total, 4) if total > 0 else 0.0,
        }

    def snapshot(self, top_n: int = 8, brief: bool = False) -> dict:
        """The status-document / CLI fragment: hot ranges, occupancy
        headroom, verdict totals, and the suggested split points."""
        if brief:
            return self.brief()
        shards = self.default_split_shards()
        splits = self.split_points(shards)
        return {
            "batches": self.batches,
            "buckets": self.buckets,
            "capacity": self.capacity,
            "occupancy": self.occupancy,
            "occupancy_frac": round(self.occupancy_frac(), 4),
            "gc_reclaimed": self.gc_reclaimed_total,
            "verdicts": dict(self.verdict_totals),
            "concentration": round(self.concentration(), 4),
            "hot_ranges": self.hot_ranges(top_n=top_n),
            "split_shards": shards,
            "split_points": [_fmt_key(k) for k in splits],
            "split_balance": [round(f, 4)
                              for f in self.split_balance(shards, splits)],
            "recent_attribution": list(self.attribution)[-top_n:],
            "history": self.history_snapshot(),
        }


def heat_buckets_from_knobs() -> int:
    """The `resolver_heat_buckets` knob: device-side histogram buckets per
    resolve step; 0 disables the whole layer (no heat outputs in any
    program, no aggregator, nothing allocated)."""
    from .knobs import SERVER_KNOBS

    return int(getattr(SERVER_KNOBS, "resolver_heat_buckets", 0) or 0)


def aggregator_for(cfg, n_shards: int = 1) -> Optional[KeyRangeHeatAggregator]:
    """Aggregator for an engine's KernelConfig, or None when heat is off.
    `n_shards` scales the capacity gauge: each key-range shard owns a
    capacity-H table, and merge_shards sums their occupancies."""
    if getattr(cfg, "heat_buckets", 0) <= 0:
        return None
    from .knobs import SERVER_KNOBS

    return KeyRangeHeatAggregator(
        key_words=cfg.key_words,
        capacity=cfg.capacity * max(1, n_shards),
        buckets=cfg.heat_buckets,
        decay=float(getattr(SERVER_KNOBS, "resolver_heat_decay", 0.98)),
    )
