"""Host side of the device-backed ConflictSet engine, and the engine.

Port of the general router of ``foundationdb_tpu/ops/host_engine.py``: the
int32 version window (device versions are offsets from a host-tracked
base), routing and clipping of every conflict range, the exact host tier for
keys beyond the device's compare window, greedy chunking against the device
caps, and fixed-shape batch packing. This slice runs one shard and one
bucket (the config's own shape); the columnar fast path, the bucket ladder
and the chunk scan are later slices, so ``resolve()`` always takes the
general router, which is exact for every input.

Batch splitting on transaction boundaries is exact: sub-batch writes land at
version `now` and every later read in the same batch has snapshot < now, so
history-vs-intra-batch classification cannot change any verdict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import error
from ..core.keyshard import KeyShardMap
from ..core.types import Key, TransactionCommitResult, Version, is_point_range as _is_point
from . import conflict_kernel as ck
from . import keypack
from .conflict_kernel import KernelConfig, build_batch_arrays
from .oracle import VersionIntervalMap


@dataclass
class _RoutedTxn:
    """One transaction's conflict ranges, clipped per shard (computed once).
    Point rows ([k, k+'\\x00')) are classified here, carrying only the key.

    Rows involving keys beyond the device's exact-compare window go to the
    host long-key tier (tier_*): long points exclusively; range rows
    additionally (membership of long keys in any range is tier-owned, while
    the device answers the same range for in-window keys via truncated
    endpoints — an exact disjoint decomposition of the keyspace)."""

    preads: List[Tuple[int, Key]]       # (shard, key)
    rreads: List[Tuple[int, Key, Key]]  # (shard, begin, end) — may be empty ranges
    pwrites: List[Tuple[int, Key]]
    rwrites: List[Tuple[int, Key, Key]] # non-empty only
    n_preads: List[int]                 # per-shard counts
    n_rreads: List[int]
    n_pwrites: List[int]
    n_rwrites: List[int]
    snapshot: Version
    #: host-tier rows (byte keys, unclipped)
    tier_preads: List[Key]              # long point reads
    tier_ereads: List[Key]              # long empty reads [k, k)
    tier_rreads: List[Tuple[Key, Key]]  # non-empty range reads (all)
    tier_pwrites: List[Key]             # long point writes
    tier_rwrites: List[Tuple[Key, Key]] # non-empty range writes (all)
    has_long: bool = False              # any long-key row in this txn

    def has_reads(self) -> bool:
        return bool(self.preads or self.rreads or self.tier_preads
                    or self.tier_ereads or self.tier_rreads)


class RoutedConflictEngineBase:
    """Host side of a device-backed ConflictSet engine. Subclasses implement
    `_run_step(per_shard_batches) -> (status[T] np.ndarray, overflow bool)`,
    the split steps `_run_detect` / `_run_fix` / `_run_apply` of the
    long-key path, and `_reset_device_state(version_rel)`."""

    name = "routed"

    def __init__(self, cfg: KernelConfig, shards: KeyShardMap):
        ck.check_supported(cfg)
        self.cfg = cfg
        self.shards = shards
        self.n_shards = shards.n_shards
        self.base: Version = 0
        self.oldest_version: Version = 0
        self._window = keypack.max_key_bytes(cfg.key_words)
        #: exact host tier for out-of-window keys (absolute versions);
        #: short-key-only workloads never touch it
        self.tier_map = VersionIntervalMap(0)
        self._tier_has_writes = False

    # -- subclass interface -------------------------------------------------
    def _run_step(self, per_shard: List[Dict[str, np.ndarray]]) -> Tuple[np.ndarray, bool]:
        """Fused detect+fix+apply (no host tier involved)."""
        raise NotImplementedError

    def _run_detect(self, per_shard: List[Dict[str, np.ndarray]]):
        """Phases 1-2; returns an opaque device context for _run_fix/_run_apply."""
        raise NotImplementedError

    def _run_fix(self, ctx, per_shard, t_ok: np.ndarray) -> np.ndarray:
        """Earlier-in-batch-wins fixpoint under an updated t_ok; committed[T]."""
        raise NotImplementedError

    def _run_apply(self, ctx, per_shard, committed: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Apply globally-agreed writes; returns (status[T], overflow)."""
        raise NotImplementedError

    def _reset_device_state(self, version_rel: int) -> None:
        raise NotImplementedError

    # -- shared implementation ---------------------------------------------
    def clear(self, version: Version) -> None:
        """reference: clearConflictSet (SkipList.cpp:957-959)."""
        self._reset_device_state(self._rel(version))
        self.tier_map = VersionIntervalMap(version)
        self._tier_has_writes = False

    def _rel(self, v: Version) -> int:
        r = v - self.base
        if r >= 2**30:
            raise error.client_invalid_operation(
                f"version {v} too far beyond base {self.base} for int32 device window"
            )
        return max(r, -1)

    def _packed_empty(self, begin: Key, end: Key) -> bool:
        """True iff a truly non-empty [begin, end) becomes empty under
        endpoint truncation (both endpoints share the window prefix): the
        device would mis-evaluate it as an empty read, so it is tier-only."""
        w = self._window
        a = (begin[:w], min(len(begin), w + 1))
        b = (end[:w], min(len(end), w + 1))
        return a >= b

    def _route_txn(self, tr) -> _RoutedTxn:
        S = self.n_shards
        rt = _RoutedTxn([], [], [], [], [0] * S, [0] * S, [0] * S, [0] * S,
                        tr.read_snapshot, [], [], [], [], [])
        w_cap = self._window
        for r in tr.read_conflict_ranges:
            if r.begin >= r.end:
                k = r.begin
                if len(k) > w_cap and not (len(k) == w_cap + 1 and k[-1] == 0):
                    # Long empty read [k, k): the interval strictly below k
                    # borders long keys, whose values only tier-visible
                    # writes can set — the tier answer is exact. The ONE
                    # exception is k = s+'\x00' with a window-sized s: there
                    # the below-interval is {s}, owned by device-side point
                    # writes, and packing k (length window+1) is exact.
                    rt.tier_ereads.append(k)
                    rt.has_long = True
                    continue
                s = self.shards.shard_of_point_below(k)
                rt.rreads.append((s, k, r.end))
                rt.n_rreads[s] += 1
            elif _is_point(r.begin, r.end) and len(r.begin) > w_cap:
                rt.tier_preads.append(r.begin)
                rt.has_long = True
            elif self._packed_empty(r.begin, r.end):
                rt.tier_rreads.append((r.begin, r.end))
                rt.has_long = True
            else:
                # Every non-point range may contain out-of-window keys: the
                # tier answers for those, the device for the in-window rest.
                if not _is_point(r.begin, r.end):
                    rt.tier_rreads.append((r.begin, r.end))
                    if len(r.begin) > w_cap or len(r.end) > w_cap:
                        rt.has_long = True
                for s, cb, ce in self.shards.shards_of_range(r.begin, r.end):
                    if _is_point(cb, ce):
                        if len(cb) > w_cap:
                            rt.has_long = True
                            continue
                        rt.preads.append((s, cb))
                        rt.n_preads[s] += 1
                    else:
                        if self._packed_empty(cb, ce):
                            rt.has_long = True
                            continue
                        rt.rreads.append((s, cb, ce))
                        rt.n_rreads[s] += 1
        for w in tr.write_conflict_ranges:
            if w.begin < w.end:
                if _is_point(w.begin, w.end) and len(w.begin) > w_cap:
                    rt.tier_pwrites.append(w.begin)
                    rt.has_long = True
                    continue
                if not _is_point(w.begin, w.end):
                    rt.tier_rwrites.append((w.begin, w.end))
                    if len(w.begin) > w_cap or len(w.end) > w_cap:
                        rt.has_long = True
                for s, cb, ce in self.shards.shards_of_range(w.begin, w.end):
                    if _is_point(cb, ce):
                        if len(cb) > w_cap:
                            rt.has_long = True
                            continue
                        rt.pwrites.append((s, cb))
                        rt.n_pwrites[s] += 1
                    else:
                        if self._packed_empty(cb, ce):
                            rt.has_long = True
                            continue
                        rt.rwrites.append((s, cb, ce))
                        rt.n_rwrites[s] += 1
        cfg = self.cfg
        if (
            max(rt.n_preads) > cfg.rp
            or max(rt.n_rreads) > cfg.max_reads
            or max(rt.n_pwrites) > cfg.wp
            or max(rt.n_rwrites) > cfg.max_writes
        ):
            raise error.client_invalid_operation(
                "single transaction exceeds device conflict-range capacity"
            )
        return rt

    def resolve(self, transactions: Sequence[Any], now: Version,
                new_oldest: Version) -> List[TransactionCommitResult]:
        """Resolve one ordered batch at version `now` and advance the GC
        horizon to `new_oldest`. Transactions are any objects carrying
        read_conflict_ranges, write_conflict_ranges and read_snapshot."""
        cfg = self.cfg
        S = self.n_shards
        routed = [self._route_txn(tr) for tr in transactions]
        results: List[TransactionCommitResult] = []
        i = 0
        ntx = len(transactions)
        caps = (
            ("n_preads", cfg.rp),
            ("n_rreads", cfg.max_reads),
            ("n_pwrites", cfg.wp),
            ("n_rwrites", cfg.max_writes),
        )
        while True:
            # Greedy prefix respecting every shard's device caps.
            j = i
            used = {f: [0] * S for f, _ in caps}
            while j < ntx and (j - i) < cfg.max_txns:
                rt = routed[j]
                if any(
                    used[f][s] + getattr(rt, f)[s] > cap
                    for f, cap in caps
                    for s in range(S)
                ):
                    break
                for f, _ in caps:
                    for s in range(S):
                        used[f][s] += getattr(rt, f)[s]
                j += 1
            last = j >= ntx
            results.extend(self._resolve_chunk(routed[i:j], now, new_oldest if last else 0))
            if last:
                break
            i = j
        if new_oldest > self.oldest_version:
            self.oldest_version = new_oldest
            self.base += max(0, new_oldest - self.base)
        return results

    def _resolve_chunk(self, routed: Sequence[_RoutedTxn], now: Version,
                       new_oldest: Version) -> List[TransactionCommitResult]:
        cfg = self.cfg
        S = self.n_shards
        n = len(routed)
        if n > cfg.max_txns:
            raise ValueError(f"chunk of {n} txns exceeds max_txns={cfg.max_txns}")

        too_old = np.zeros((cfg.max_txns,), bool)
        t_ok = np.zeros((cfg.max_txns,), bool)
        rpk: List[List[bytes]] = [[] for _ in range(S)]
        rps: List[List[int]] = [[] for _ in range(S)]
        rpt: List[List[int]] = [[] for _ in range(S)]
        rb: List[List[bytes]] = [[] for _ in range(S)]
        re_: List[List[bytes]] = [[] for _ in range(S)]
        rs: List[List[int]] = [[] for _ in range(S)]
        rt_: List[List[int]] = [[] for _ in range(S)]
        wpk: List[List[bytes]] = [[] for _ in range(S)]
        wpt: List[List[int]] = [[] for _ in range(S)]
        wb: List[List[bytes]] = [[] for _ in range(S)]
        we: List[List[bytes]] = [[] for _ in range(S)]
        wt: List[List[int]] = [[] for _ in range(S)]
        for t, rt in enumerate(routed):
            is_old = rt.snapshot < self.oldest_version and rt.has_reads()
            too_old[t] = is_old
            t_ok[t] = not is_old
            if is_old:
                continue
            snap = self._rel(rt.snapshot)
            for s, k in rt.preads:
                rpk[s].append(k)
                rps[s].append(snap)
                rpt[s].append(t)
            for s, cb, ce in rt.rreads:
                rb[s].append(cb)
                re_[s].append(ce)
                rs[s].append(snap)
                rt_[s].append(t)
            for s, k in rt.pwrites:
                wpk[s].append(k)
                wpt[s].append(t)
            for s, cb, ce in rt.rwrites:
                wb[s].append(cb)
                we[s].append(ce)
                wt[s].append(t)

        now_rel = self._rel(now)
        gc_rel = self._rel(new_oldest) if new_oldest > self.oldest_version else 0
        per = [
            build_batch_arrays(
                cfg,
                rpk[s], rps[s], rpt[s],
                rb[s], re_[s], rs[s], rt_[s],
                wpk[s], wpt[s],
                wb[s], we[s], wt[s],
                t_ok, too_old, now_rel, gc_rel,
            )
            for s in range(S)
        ]

        chunk_has_long = any(rt.has_long for rt in routed)
        chunk_has_rreads = any(rt.tier_rreads for rt in routed)
        chunk_has_rwrites = any(rt.tier_rwrites for rt in routed)
        # Slow (split-step) path only when verdicts can couple across tiers:
        # long rows present, or range reads that tier-held write history
        # could hit. Range-write-only chunks stay fused and just record.
        slow = chunk_has_long or (self._tier_has_writes and chunk_has_rreads)

        if not slow:
            status, overflow = self._run_step(per)
            if overflow:
                raise error.conflict_capacity_exceeded(
                    f"a shard's boundary table needs > {cfg.capacity} rows"
                )
            results = [TransactionCommitResult(int(v)) for v in status[:n]]
            if chunk_has_rwrites:
                self._tier_record(routed, results, now, new_oldest)
            elif new_oldest > self.oldest_version:
                self.tier_map.gc(new_oldest)
            return results

        # ---- split-step path: global verdicts BEFORE any writes ----------
        # Tier history hits are t_ok-level aborts; tier intra-batch edges
        # join the device fixpoint through an outer iteration that converges
        # to the oracle's sequential-sweep verdicts (all edges point earlier
        # txn -> later txn, so each round finalizes a growing prefix).
        tier_hist = np.zeros((cfg.max_txns,), bool)
        for t, rt in enumerate(routed):
            if not t_ok[t]:
                continue
            snap = rt.snapshot
            hit = False
            for k in rt.tier_preads:
                if self.tier_map.range_max(k, k + b"\x00") > snap:
                    hit = True
                    break
            if not hit:
                for k in rt.tier_ereads:
                    if self.tier_map.version_strictly_below(k) > snap:
                        hit = True
                        break
            if not hit:
                for b, e in rt.tier_rreads:
                    if self.tier_map.range_max(b, e) > snap:
                        hit = True
                        break
            tier_hist[t] = hit

        # Unconditional tier intra-batch edges (u writes, t reads, u < t);
        # whether an edge blocks depends on u's GLOBAL verdict each round.
        edges: List[Tuple[int, int]] = []
        writes_by_txn: List[List[Tuple[Key, Key]]] = []
        for u, ru in enumerate(routed):
            ws = [(k, k + b"\x00") for k in ru.tier_pwrites] + list(ru.tier_rwrites)
            writes_by_txn.append(ws)
        for t, rt in enumerate(routed):
            if not t_ok[t]:
                continue
            reads = [(k, k + b"\x00") for k in rt.tier_preads] + list(rt.tier_rreads)
            if not reads:
                continue
            for u in range(t):
                if any(rb_ < we_ and wb_ < re__
                       for (rb_, re__) in reads
                       for (wb_, we_) in writes_by_txn[u]):
                    edges.append((u, t))

        ctx = self._run_detect(per)
        cur_abort = tier_hist.copy()
        committed = self._run_fix(ctx, per, t_ok & ~cur_abort)
        for _ in range(n + 1):
            blocked = np.zeros((cfg.max_txns,), bool)
            for u, t in edges:
                if committed[u]:
                    blocked[t] = True
            new_abort = tier_hist | blocked
            if np.array_equal(new_abort, cur_abort):
                break
            cur_abort = new_abort
            committed = self._run_fix(ctx, per, t_ok & ~cur_abort)

        status, overflow = self._run_apply(ctx, per, committed)
        if overflow:
            raise error.conflict_capacity_exceeded(
                f"a shard's boundary table needs > {cfg.capacity} rows"
            )
        results = [TransactionCommitResult(int(v)) for v in status[:n]]
        self._tier_record(routed, results, now, new_oldest)
        return results

    def _write_lossy_on_device(self, b: Key, e: Key) -> bool:
        """True iff the device's truncated image of write [b, e) loses
        coverage somewhere — only such writes force later range reads onto
        the split-step path."""
        w = self._window
        if len(b) > w or len(e) > w or self._packed_empty(b, e):
            return True
        for s, cb, ce in self.shards.shards_of_range(b, e):
            if _is_point(cb, ce):
                if len(cb) > w:
                    return True
            elif self._packed_empty(cb, ce):
                return True
        return False

    def _tier_record(self, routed, results, now: Version, new_oldest: Version) -> None:
        """Record COMMITTED tier writes into the host tier map + GC."""
        for t, rt in enumerate(routed):
            if results[t] != TransactionCommitResult.COMMITTED:
                continue
            for k in rt.tier_pwrites:
                self.tier_map.write(k, k + b"\x00", now)
                self._tier_has_writes = True
            for b, e in rt.tier_rwrites:
                self.tier_map.write(b, e, now)
                if not self._tier_has_writes and self._write_lossy_on_device(b, e):
                    self._tier_has_writes = True
        if new_oldest > self.oldest_version:
            self.tier_map.gc(new_oldest)


def _default_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchConflictEngine runs on the card by default and CUDA is not "
                "available; pass device='cpu' to run it on the CPU")
        device = "cuda"
    return torch.device(device)


class TorchConflictEngine(RoutedConflictEngineBase):
    """Single-card ConflictSet engine backed by the torch conflict step and
    the CUDA fixpoint kernel (one shard). Same resolve() contract as
    OracleConflictEngine. `device=None` means the card, and raises where
    there is none; `device="cpu"` runs the same step on the CPU, with the
    plain fixpoint."""

    name = "torch"

    def __init__(self, cfg: KernelConfig = KernelConfig(), initial_version: Version = 0,
                 device=None):
        super().__init__(cfg, KeyShardMap([]))
        self.device = _default_device(device)
        self.state = ck.initial_state(cfg, version_rel=initial_version, device=self.device)
        self.tier_map = VersionIntervalMap(initial_version)

    def _reset_device_state(self, version_rel: int) -> None:
        self.state = ck.initial_state(self.cfg, version_rel=version_rel, device=self.device)

    def load_state(self, state_np: Dict[str, np.ndarray], base: Version,
                   oldest_version: Version, tier_map=None) -> None:
        """Adopt another engine's interval table mid-stream: numpy
        {"hkeys", "hvers", "n"} (base-relative versions), its version base
        and GC horizon, and optionally its host long-key tier (any object
        with `keys` / `vers` lists)."""
        self.state = ck.state_from_numpy(self.cfg, state_np, self.device)
        self.base = base
        self.oldest_version = oldest_version
        self.tier_map = VersionIntervalMap(0)
        if tier_map is not None:
            self.tier_map.keys = list(tier_map.keys)
            self.tier_map.vers = list(tier_map.vers)
        self._tier_has_writes = len(self.tier_map) > 1

    def _batch(self, per_shard) -> Dict:
        (arrays,) = per_shard
        return ck.batch_from_numpy(self.cfg, arrays, self.device)

    def _run_step(self, per_shard) -> Tuple[np.ndarray, bool]:
        self.state, out = ck.resolve_step(self.cfg, self.state, self._batch(per_shard))
        return out["status"].cpu().numpy(), bool(out["overflow"])

    def _run_detect(self, per_shard):
        batch = self._batch(per_shard)
        hist, edges, wpos = ck.detect_step(self.cfg, self.state, batch)
        return {"batch": batch, "hist": hist, "edges": edges, "wpos": wpos}

    def _run_fix(self, ctx, per_shard, t_ok: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(t_ok)).to(self.device)
        committed = ck.fix_step(self.cfg, t, ctx["hist"], ctx["edges"], ctx["batch"])
        return committed.cpu().numpy()

    def _run_apply(self, ctx, per_shard, committed: np.ndarray) -> Tuple[np.ndarray, bool]:
        cm = torch.from_numpy(np.ascontiguousarray(committed)).to(self.device)
        batch = ctx["batch"]
        self.state, overflow = ck.apply_step(self.cfg, self.state, batch, cm, ctx["wpos"])
        status = ck.status_of(batch["t_too_old"], cm)
        return status.cpu().numpy(), bool(overflow)


ENGINE_MODES = ("torch",)


def make_engine(mode: str, cfg: KernelConfig, **kw):
    """Registry entry point: build the engine family `mode` names. This
    slice ports the single-card step engine only."""
    if mode == "torch":
        return TorchConflictEngine(cfg, **kw)
    raise ValueError(f"unknown engine mode {mode!r}; expected one of {ENGINE_MODES}")
