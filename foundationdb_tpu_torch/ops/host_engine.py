"""Host side of the device-backed ConflictSet engine, and the engine.

Port of ``foundationdb_tpu/ops/host_engine.py`` for one shard: the int32
version window (device versions are offsets from a host-tracked base),
routing and clipping of every conflict range, the exact host tier for keys
beyond the device's compare window, greedy chunking against the device
caps, and fixed-shape batch packing — the general router — plus the serving
path the JAX engine takes first:

  columnar_pack      conflict-wire blocks -> padded point-row arrays by two
                     native passes (csrc/fastpack.c) into pooled pack
                     buffers (HostPackArena), pinned on the card; no
                     per-range Python runs
  bucket ladder      each chunk runs on the smallest bucket shape it fits
                     (KernelConfig.bucket); every bucket shares the one
                     capacity-sized table
  chunk scan         consecutive same-bucket chunks run as ONE program of C
                     steps (conflict_kernel.resolve_step_scan); on the card
                     each (bucket, C) program is a captured CUDA graph over
                     static input and state buffers, the port's counterpart
                     of the JAX engine's AOT-compiled programs
  columnar_dispatch  copies in, replays, copies the verdicts out — all
                     stream-ordered, no host sync; force() waits on an event
  keyspace heat      with cfg.heat_buckets > 0 (the `resolver_heat_buckets`
                     knob, default 64) every step emits a heat aggregate
                     (conflict_kernel.heat_of), copied out beside the
                     verdicts and merged into the engine's
                     KeyRangeHeatAggregator (core/heatmap.py) at force()
  observability      EnginePerf counters and its flight-recorder ring, a
                     perf-ledger row per program build (core/perfledger.py),
                     sampled device timing (1 dispatch unit in N, knob
                     `resolver_device_time_sample_rate`: CUDA events around
                     the unit's copies and replay on the card, read once
                     the unit is done; the interval holds the stream's
                     idle time while the host issues the unit, not only
                     device work), the engine.* spans (core/trace.py),
                     and the hub registrations (core/telemetry.py)

The ladder, history search mode, history structure and heat buckets come
from the constructor, else a non-default config, else the knobs
(`resolver_bucket_ladder`, `resolver_history_search_mode`,
`resolver_history_structure` / `resolver_history_runs`,
`resolver_heat_buckets`), in the JAX package's precedence.

``resolve()`` tries the columnar path first and takes the general router
when any range is not a short-key point row.

Batch splitting on transaction boundaries is exact: sub-batch writes land at
version `now` and every later read in the same batch has snapshot < now, so
history-vs-intra-batch classification cannot change any verdict.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import error, heatmap, perfledger, progcache, telemetry, wire
from ..core.keyshard import KeyShardMap
from ..core.knobs import SERVER_KNOBS
from ..core.trace import g_spans, span_event, span_now
from ..core.types import Key, TransactionCommitResult, Version, is_point_range as _is_point
from ..native import fastpack
from . import conflict_kernel as ck
from . import fixpoint_cuda
from . import graph_if
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

def wire_pass1(window: int, blocks: List[bytes]):
    """Native pass 1 over concatenated conflict-wire blocks: per-txn POINT
    row counts. Returns (blob, offs, rp_cnt, wp_cnt), or None when the batch
    has any range, empty or long-key row (the general router takes it)."""
    if not blocks:
        return None
    lib = fastpack.lib()
    n = len(blocks)
    blob = b"".join(blocks)
    offs = np.zeros((n + 1,), np.int64)
    np.cumsum(np.fromiter((len(b) for b in blocks), np.int64, count=n), out=offs[1:])
    rp_cnt = np.zeros((n,), np.int32)
    wp_cnt = np.zeros((n,), np.int32)
    rc = lib.conflict_counts(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, window,
        rp_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        wp_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return blob, offs, rp_cnt, wp_cnt


# ---------------------------------------------------------------------------
# one chunk's batch: a tensor per field
# ---------------------------------------------------------------------------

#: batch fields the columnar pack writes (copied to the card per chunk) ...
HOT_FIELDS = ("t_ok", "t_too_old", "now", "gc", "rp_valid", "wp_valid",
              "rp_snap", "rp_txn", "wp_txn", "rpb", "wpb")
#: ... and the range-row fields, all zero on the columnar path
COLD_FIELDS = ("r_valid", "w_valid", "r_snap", "r_txn", "w_txn", "rb", "re", "wb", "we")
_KEY_MASK = 0xFFFFFFFF


def input_shapes(cfg: KernelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shape and dtype of each batch field as it crosses to the card: the
    step's (ck.batch_shapes), except that keys travel as the int32 bits of
    their uint32 words (half the int64 the step computes in) and widen
    inside the program."""
    return {name: (tuple(shape), torch.int32 if name in ck.KEY_FIELDS else dtype)
            for name, (shape, dtype) in ck.batch_shapes(cfg).items()}


def host_tensors(cfg: KernelConfig, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """CPU tensors over every field of a batch dict (build_batch_arrays'
    form) at the input shapes and dtypes: keys as the int32 bits of their
    words."""
    out = {}
    for name, (shape, _) in input_shapes(cfg).items():
        a = np.asarray(arrays[name])
        if name in ck.KEY_FIELDS:
            a = np.ascontiguousarray(a, np.uint32).view(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a).reshape(shape))
    return out


class PackSet:
    """One chunk's host pack buffers: a tensor per hot field at a bucket's
    input shapes (pinned when the engine is on the card, so each copy to
    the card is asynchronous), and numpy views of them, keys as uint32."""

    __slots__ = ("tensors", "arrays", "pinned")

    def __init__(self, cfg: KernelConfig, pin: bool = False):
        shapes = input_shapes(cfg)
        self.pinned = pin
        self.tensors = {name: torch.zeros(shapes[name][0], dtype=shapes[name][1], pin_memory=pin)
                        for name in HOT_FIELDS}
        self.arrays = {name: t.numpy().view(np.uint32) if name in ck.KEY_FIELDS else t.numpy()
                       for name, t in self.tensors.items()}


class ArenaLease:
    """Checkout handle for one chunk's pack buffers. A dispatched copy may
    still be reading them, so they return to the pool only when release()
    is called — columnar_dispatch's force() does it after the unit's event
    completed. An unreleased lease is merely unpooled: the buffers fall to
    the GC, never to reuse-while-read."""

    __slots__ = ("_arena", "_key", "pack")

    def __init__(self, arena: "HostPackArena", key, pack: PackSet):
        self._arena = arena
        self._key = key
        self.pack = pack

    def release(self) -> None:
        if self.pack is not None:
            self._arena._give_back(self._key, self.pack)
            self.pack = None


class HostPackArena:
    """Pooled pack buffers keyed by bucket shape, so a chunk allocates
    nothing in steady state.

    Reuse is bit-safe WITHOUT zeroing the key planes: every row beyond a
    group's valid prefix is dead — invalid rows sort under an all-ones key
    override, their hits are masked by the *_valid lanes, and the segment
    reduces only cover valid prefixes. Only the [T] t_ok / t_too_old lanes
    (whole-array semantics) are cleared per checkout (wire_chunk_arrays).
    The range-row fields are zero forever on the columnar path, so one
    immutable zero set per shape is shared by every chunk.

    With `pin`, prefill() — called from warmup() on the thread that owns
    the card — puts pinned sets in the pool. A lease that finds the pool
    empty makes a pageable set (a `miss`): lease() runs on the pipeline's
    pack thread and touches no CUDA state. Thread-safe."""

    MAX_POOLED = 32
    #: pinned sets warmup() puts in each bucket's pool: enough for a few
    #: batches of several chunks in flight
    PREFILL = 16

    def __init__(self, pin: bool = False) -> None:
        self.pin = pin
        self._lock = threading.Lock()
        self._pools: Dict[KernelConfig, List[PackSet]] = {}
        self._shared: Dict[KernelConfig, Dict[str, np.ndarray]] = {}
        #: sets made because the pool was empty
        self.misses = 0

    def prefill(self, cfg: KernelConfig, n: int = PREFILL) -> None:
        made = [PackSet(cfg, pin=self.pin) for _ in range(n)]
        with self._lock:
            pool = self._pools.setdefault(cfg, [])
            pool.extend(made[:max(0, self.MAX_POOLED - len(pool))])

    def lease(self, cfg: KernelConfig) -> Tuple[Dict[str, np.ndarray], ArenaLease]:
        """Buffers for one chunk at `cfg`'s shapes: (bufs, lease). bufs holds
        the set's hot views, the shared zero range rows and cached
        aranges."""
        with self._lock:
            shared = self._shared.get(cfg)
            if shared is None:
                shared = self._shared[cfg] = shared_arrays(cfg)
            pool = self._pools.get(cfg)
            pack = pool.pop() if pool else None
            if pack is None:
                self.misses += 1
        if pack is None:
            pack = PackSet(cfg)
        out = dict(shared)
        out.update(pack.arrays)
        return out, ArenaLease(self, cfg, pack)

    def _give_back(self, cfg: KernelConfig, pack: PackSet) -> None:
        with self._lock:
            pool = self._pools.setdefault(cfg, [])
            if len(pool) < self.MAX_POOLED:
                # pinned sets go to the end, which lease() pops first
                if pack.pinned:
                    pool.append(pack)
                else:
                    pool.insert(0, pack)


def shared_arrays(cfg: KernelConfig) -> Dict[str, np.ndarray]:
    """The zero range-row arrays and the aranges a columnar chunk shares."""
    K, Rr, Wr = cfg.lanes, cfg.max_reads, cfg.max_writes
    return {
        "rb": np.zeros((Rr, K), np.uint32), "re": np.zeros((Rr, K), np.uint32),
        "r_snap": np.zeros((Rr,), np.int32), "r_txn": np.zeros((Rr,), np.int32),
        "r_valid": np.zeros((Rr,), bool),
        "wb": np.zeros((Wr, K), np.uint32), "we": np.zeros((Wr, K), np.uint32),
        "w_txn": np.zeros((Wr,), np.int32), "w_valid": np.zeros((Wr,), bool),
        "_arange_rp": np.arange(cfg.rp), "_arange_wp": np.arange(cfg.wp),
    }


def fresh_bufs(cfg: KernelConfig) -> Tuple[Dict[str, np.ndarray], PackSet]:
    """Unpooled pack buffers for one chunk (an engine built with
    arena=False): (bufs, the set behind them)."""
    pack = PackSet(cfg)
    bufs = shared_arrays(cfg)
    bufs.update(pack.arrays)
    return bufs, pack


def wire_chunk_arrays(
    cfg: KernelConfig,
    blob: bytes,
    offs: np.ndarray,
    t0: int,
    t1: int,
    skip: np.ndarray,          # uint8 [ntx], 1 = contribute no rows (too old)
    snap_rel: np.ndarray,      # int32 [ntx]
    eff_r: np.ndarray,         # int32 [ntx] read counts with skipped txns zeroed
    now_rel: int,
    gc_rel: int,
    bufs: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Native pass 2: the batch dict for txns [t0, t1) straight from wire
    bytes — the point rows written into their padded arrays by C, the int
    lanes by vectorized numpy. `bufs` (HostPackArena.lease or fresh_bufs)
    supplies the buffers; rows beyond each valid prefix stay stale — masked
    by the *_valid lanes (see HostPackArena)."""
    if bufs is None:
        bufs, _ = fresh_bufs(cfg)
    lib = fastpack.lib()
    n = t1 - t0
    rpb, rp_txn = bufs["rpb"], bufs["rp_txn"]
    wpb, wp_txn = bufs["wpb"], bufs["wp_txn"]
    out_n = np.zeros((2,), np.int64)
    lib.build_point_rows(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        t0, t1, bytes(skip), cfg.key_words,
        rpb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        rp_txn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        wpb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        wp_txn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    n_rp, n_wp = int(out_n[0]), int(out_n[1])
    rp_snap = bufs["rp_snap"]
    rp_snap[:n_rp] = np.repeat(snap_rel[t0:t1], eff_r[t0:t1])
    t_ok, t_too_old = bufs["t_ok"], bufs["t_too_old"]
    t_ok.fill(False)
    t_too_old.fill(False)
    t_too_old[:n] = skip[t0:t1] != 0
    t_ok[:n] = ~t_too_old[:n]
    rp_valid, wp_valid = bufs["rp_valid"], bufs["wp_valid"]
    np.less(bufs["_arange_rp"], n_rp, out=rp_valid)
    np.less(bufs["_arange_wp"], n_wp, out=wp_valid)
    bufs["now"][...] = now_rel
    bufs["gc"][...] = gc_rel
    return {
        "rpb": rpb, "rp_snap": rp_snap, "rp_txn": rp_txn, "rp_valid": rp_valid,
        "rb": bufs["rb"], "re": bufs["re"], "r_snap": bufs["r_snap"],
        "r_txn": bufs["r_txn"], "r_valid": bufs["r_valid"],
        "wpb": wpb, "wp_txn": wp_txn, "wp_valid": wp_valid,
        "wb": bufs["wb"], "we": bufs["we"], "w_txn": bufs["w_txn"], "w_valid": bufs["w_valid"],
        "t_ok": t_ok, "t_too_old": t_too_old, "now": bufs["now"], "gc": bufs["gc"],
    }


#: dispatch-ring size of EnginePerf.recent
DISPATCH_RING_SIZE = 64


def _dispatch_ring():
    return deque(maxlen=DISPATCH_RING_SIZE)


@dataclass
class EnginePerf:
    """Serving-path performance counters of a bucketed engine: the JAX
    EnginePerf's, plus the card's graph and merge counts."""

    #: programs built (one per (bucket, chunk-count) shape ever dispatched;
    #: the loop engine: one per bucket); after warmup() this must NOT grow
    #: in steady state
    compiles: int = 0
    #: CUDA graphs captured (two per program on the card); 0 on the CPU
    captures: int = 0
    #: chunks dispatched per bucket T (columnar path)
    bucket_hits: Dict[int, int] = field(default_factory=dict)
    #: dispatches per chunk-scan length (1 = single-chunk program)
    scan_dispatches: Dict[int, int] = field(default_factory=dict)
    #: resolved history-search mode per bucket T, picked at ladder build
    search_modes: Dict[int, str] = field(default_factory=dict)
    #: chunks dispatched per history-search mode
    search_mode_hits: Dict[str, int] = field(default_factory=dict)
    #: chunks dispatched per dispatch mode ("step" | "loop")
    dispatch_mode_hits: Dict[str, int] = field(default_factory=dict)
    #: transactions by final verdict: committed / conflicts / too_old
    verdicts: Dict[str, int] = field(default_factory=dict)
    #: sampled device timing per bucket T: {T: {samples, chunks, ms_total}};
    #: on the card a sample is the unit's interval on the stream (its
    #: copies and kernels, and the time the stream idles while the host
    #: issues them), on the CPU the dispatch-to-force wall interval
    device_time: Dict[int, Dict[str, float]] = field(default_factory=dict)
    warmup_ms: float = 0.0
    warmed: bool = False
    #: tiered steps that merged the run stack into the base table (each
    #: step's "merged" flag, read where its statuses are)
    merges: int = 0
    #: flight recorder: a bounded ring of recent dispatch units — bucket,
    #: scan length, txns covered, and the force wall ms once forced
    recent: "deque" = field(default_factory=_dispatch_ring)

    def record_dispatch(self, bucket: int, scan: int, txns: int) -> dict:
        rec = {"bucket": bucket, "scan": scan, "txns": txns, "force_ms": None}
        self.recent.append(rec)
        return rec

    def record_search_mode(self, bucket: int, chunks: int) -> None:
        mode = self.search_modes.get(bucket, "fused_sort")
        self.search_mode_hits[mode] = self.search_mode_hits.get(mode, 0) + chunks

    def record_dispatch_mode(self, mode: str, chunks: int) -> None:
        self.dispatch_mode_hits[mode] = self.dispatch_mode_hits.get(mode, 0) + chunks

    def record_device_time(self, bucket: int, ms: float, chunks: int = 1) -> None:
        """Fold one SAMPLED dispatch unit's measured time, covering `chunks`
        chunks, into the per-bucket accumulators: on the card the unit's
        device interval from its first copy in to its last copy out (CUDA
        events), on the CPU its enqueue->ready wall interval."""
        d = self.device_time.setdefault(bucket, {"samples": 0, "chunks": 0, "ms_total": 0.0})
        d["samples"] += 1
        d["chunks"] += chunks
        d["ms_total"] += float(ms)

    def device_time_ms_by_bucket(self) -> Dict[int, float]:
        """Mean measured per-CHUNK ms per bucket over every sample."""
        return {b: round(d["ms_total"] / d["chunks"], 4)
                for b, d in self.device_time.items() if d["chunks"]}

    def record_verdicts(self, status) -> None:
        """Fold one chunk's statuses into the verdict counters."""
        arr = np.asarray(status, dtype=np.int64)
        if arr.size == 0:
            return
        committed = int(np.sum(arr == int(TransactionCommitResult.COMMITTED)))
        too_old = int(np.sum(arr == int(TransactionCommitResult.TOO_OLD)))
        v = self.verdicts
        v["committed"] = v.get("committed", 0) + committed
        v["too_old"] = v.get("too_old", 0) + too_old
        v["conflicts"] = v.get("conflicts", 0) + int(arr.size) - committed - too_old

    def as_dict(self) -> dict:
        return {
            "compiles": self.compiles,
            "captures": self.captures,
            "bucket_hits": {str(k): v for k, v in sorted(self.bucket_hits.items())},
            "scan_dispatches": {str(k): v for k, v in sorted(self.scan_dispatches.items())},
            "search_modes": {str(k): v for k, v in sorted(self.search_modes.items())},
            "search_mode_hits": dict(sorted(self.search_mode_hits.items())),
            "dispatch_mode_hits": dict(sorted(self.dispatch_mode_hits.items())),
            "verdicts": dict(sorted(self.verdicts.items())),
            "device_time_ms": {str(b): v for b, v in
                               sorted(self.device_time_ms_by_bucket().items())},
            "device_time_samples": {str(b): d["samples"]
                                    for b, d in sorted(self.device_time.items())},
            "warmup_ms": round(self.warmup_ms, 1),
            "warmed": self.warmed,
            "merges": self.merges,
            "recent_dispatches": len(self.recent),
        }


def ladder_from_knob() -> Optional[List[int]]:
    """Parse the `resolver_bucket_ladder` knob ("512,1024,2048") into bucket
    sizes; empty/unset means single-bucket. Entries are NOT validated here:
    an engine keeps only the sizes below its own top shape, while a size
    that fits but breaks the %32 layout fails loudly in bucket()."""
    raw = str(getattr(SERVER_KNOBS, "resolver_bucket_ladder", "") or "").strip()
    if not raw:
        return None
    return [int(tok) for tok in raw.replace(" ", "").split(",") if tok]


class RoutedConflictEngineBase:
    """Host side of a device-backed ConflictSet engine. Subclasses implement
    `_dispatch_unit(bucket, per_chunks, packs)` (C same-bucket chunks as one
    program; returns force() -> (status [C, T], overflow)), the split steps
    `_run_detect` / `_run_fix` / `_run_apply` of the long-key path, and
    `_reset_device_state(version_rel)`.

    Bucket ladder: `ladder` lists sub-capacity batch sizes (each < the
    config's max_txns and a multiple of 32; the config itself is always
    the top bucket; None = the top bucket only). Every bucket's program
    shares the one capacity-sized table, so a chunk runs on the smallest
    bucket whose batch-side shapes fit. Consecutive same-bucket chunks fuse
    into one program of C steps for C in `scan_sizes`; warmup() builds
    every (bucket, C) program up front.

    `device_time_sample_rate` (None: the `resolver_device_time_sample_rate`
    knob) times every round(1/rate)-th dispatch unit; 0 times none."""

    name = "routed"
    #: how columnar_dispatch hands chunks to the device: "step" runs a
    #: program per dispatch unit and force() waits on its outputs; "loop"
    #: (ops/device_loop.py) enqueues onto the device loop and force()
    #: drains its result ring. Telemetry (dispatch_mode_hits), the
    #: BudgetBatcher's EWMA keys and the span names key off it.
    dispatch_mode = "step"

    def __init__(self, cfg: KernelConfig, shards: KeyShardMap,
                 ladder: Optional[Sequence[int]] = None,
                 scan_sizes: Sequence[int] = (2, 4, 8),
                 arena: bool = True, pin_memory: bool = False,
                 history_search: Optional[str] = None,
                 heat_buckets: Optional[int] = None,
                 device_time_sample_rate: Optional[float] = None,
                 history_structure: Optional[str] = None):
        cfg = self._resolve_history_search(cfg, history_search)
        cfg = self._resolve_history_structure(cfg, history_structure)
        cfg = self._resolve_heat(cfg, heat_buckets)
        ck.check_supported(cfg)
        self.cfg = cfg
        #: batch version that heat attribution samples carry: the version
        #: of the chunk being dispatched (None outside a dispatch)
        self._heat_version: Optional[Version] = None
        self.shards = shards
        self.n_shards = shards.n_shards
        self.base: Version = 0
        self.oldest_version: Version = 0
        self._window = keypack.max_key_bytes(cfg.key_words)
        #: exact host tier for out-of-window keys (absolute versions);
        #: short-key-only workloads never touch it
        self.tier_map = VersionIntervalMap(0)
        self._tier_has_writes = False
        if ladder is None:
            ladder = ladder_from_knob() or []
        # only sizes below this engine's top shape apply (ladder_from_knob)
        sizes = sorted({t for t in ladder if t < cfg.max_txns})
        self.buckets: List[KernelConfig] = [cfg.bucket(t) for t in sizes] + [cfg]
        self._scan_sizes = tuple(sorted({int(c) for c in scan_sizes if c > 1}))
        #: (bucket_T, n_chunks) -> program (engine-specific handle)
        self._programs: Dict[Tuple[int, int], Any] = {}
        self.perf = EnginePerf(
            bucket_hits={b.max_txns: 0 for b in self.buckets},
            search_modes={b.max_txns: ck.resolved_history_search(b) for b in self.buckets})
        #: one row per program build; "warmup" vs "steady" by the flag
        #: warmup() holds
        self.perf_ledger = perfledger.PerfLedger()
        self._warming = False
        #: sampled device timing: deterministic 1-in-N dispatch-unit
        #: cadence, no rng; 0 = off
        self._sample_every = perfledger.sample_every_from_rate(device_time_sample_rate)
        self._dispatch_seq = 0
        self.arena: Optional[HostPackArena] = HostPackArena(pin=pin_memory) if arena else None
        #: the keyspace-heat aggregator (None with heat off); every step's
        #: aggregate merges into it when its unit is forced
        self.heat = heatmap.aggregator_for(cfg)
        hub = telemetry.hub()
        hub.register_engine_perf(self.perf, name=self.name)
        hub.register_perf_ledger(self.perf_ledger, name=self.name)
        if self.heat is not None:
            hub.register_heat(self.heat, name=self.name)
        if self.history_structure == "tiered":
            # registered only when the structure is live, so a monolithic
            # engine's exposition carries no history series
            hub.register_history(self, name=self.name)

    # -- bucket ladder / programs -------------------------------------------
    def bucket_for(self, n_txns: int, n_reads: int, n_writes: int) -> KernelConfig:
        """Smallest bucket that fits a chunk's txn count and point-row
        counts; the top bucket always fits by chunk construction."""
        for b in self.buckets:
            if n_txns <= b.max_txns and n_reads <= b.rp and n_writes <= b.wp:
                return b
        return self.buckets[-1]

    def _program(self, bucket: KernelConfig, n_chunks: int):
        key = (bucket.max_txns, n_chunks)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_and_record(bucket, n_chunks)
        return prog

    def _progcache_fingerprint(self) -> str:
        """The sharding-layout half of the progcache key (core/progcache
        `key(mesh=)`): "" for single-card engines. The device count of
        the process itself rides `backend_fingerprint()`."""
        return ""

    def _history_fingerprint(self) -> str:
        """The history-structure half of the progcache key (core/progcache
        `key(structure=)`): "" for the monolithic table, "tiered:<runs>x
        <rows>" when the programs carry the tiered run planes, so a
        structure or run-geometry flip is a clean miss."""
        if self.history_structure != "tiered":
            return ""
        return f"tiered:{self.cfg.run_slots}x{self.cfg.run_rows}"

    def _build_and_record(self, bucket: KernelConfig, n_chunks: int):
        """Build one program, bump the compile counter, and file the build
        in the perf ledger: its duration (on the card: the captures) and
        peak device bytes, keyed (bucket, search mode, dispatch mode),
        "warmup" inside warmup() and "steady" otherwise.

        With an on-disk program cache installed (core/progcache.py) the
        cache is asked first under the same key: a hit returns the loaded
        program with no build, filed as a progcache hit, never a compile;
        a fresh build is offered back to the cache (which refuses every
        port program: a captured graph does not serialize, see progcache)."""
        search_mode = self.perf.search_modes.get(
            bucket.max_txns, ck.resolved_history_search(bucket))
        cache = progcache.active()
        key = None
        if cache is not None:
            key = cache.key(engine=self.name, bucket=bucket.max_txns, n_chunks=n_chunks,
                            search_mode=search_mode, dispatch_mode=self.dispatch_mode,
                            mesh=self._progcache_fingerprint(),
                            structure=self._history_fingerprint(),
                            device=getattr(self, "device", None))
            b0 = cache.stats["hit_bytes"]
            t0 = time.perf_counter()
            prog = cache.load(key)
            if prog is not None:
                self.perf_ledger.record_progcache(
                    engine=self.name, bucket=bucket.max_txns, event="hit",
                    nbytes=cache.stats["hit_bytes"] - b0,
                    duration_ms=(time.perf_counter() - t0) * 1e3)
                return prog
            self.perf_ledger.record_progcache(engine=self.name, bucket=bucket.max_txns,
                                              event="miss")
        t0 = time.perf_counter()
        prog, peak = self._measured_build(lambda: self._make_program(bucket, n_chunks))
        self.perf.compiles += 1
        self.perf_ledger.record_compile(
            engine=self.name, bucket=bucket.max_txns, n_chunks=n_chunks,
            search_mode=search_mode, dispatch_mode=self.dispatch_mode,
            kind="warmup" if self._warming else "steady",
            duration_ms=(time.perf_counter() - t0) * 1e3,
            analysis=perfledger.analyze_program(peak))
        if cache is not None:
            b0 = cache.stats["store_bytes"]
            t0 = time.perf_counter()
            if cache.store(key, prog):
                self.perf_ledger.record_progcache(
                    engine=self.name, bucket=bucket.max_txns, event="store",
                    nbytes=cache.stats["store_bytes"] - b0,
                    duration_ms=(time.perf_counter() - t0) * 1e3)
        return prog

    def _measured_build(self, build: Callable[[], Any]) -> Tuple[Any, Optional[int]]:
        """Run build() -> (program, its peak device bytes, or None where
        there is no device-memory reading)."""
        return build(), None

    def _make_program(self, bucket: KernelConfig, n_chunks: int):
        """Build the program for `n_chunks` stacked chunks at `bucket`
        shapes (1 = one step, > 1 = the chunk scan)."""
        raise NotImplementedError

    def warmup(self, buckets: Optional[Sequence[KernelConfig]] = None,
               scan_sizes: Optional[Sequence[int]] = None) -> "RoutedConflictEngineBase":
        """Build every (bucket, scan-size) program the serving path can
        dispatch, and fill the pack arena, so that steady state captures
        nothing. Idempotent; returns self for chaining."""
        t0 = time.perf_counter()
        self._warming = True
        try:
            for b in (buckets if buckets is not None else self.buckets):
                for c in (1,) + tuple(scan_sizes if scan_sizes is not None else self._scan_sizes):
                    self._program(b, c)
                if self.arena is not None and self.arena.pin:
                    self.arena.prefill(b)
        finally:
            self._warming = False
        self.perf.warmup_ms += (time.perf_counter() - t0) * 1e3
        self.perf.warmed = True
        return self

    def ensure_warm(self, used_only: bool = True) -> None:
        """(Re-)warm program coverage: all of it, or only the buckets that
        served traffic (a stream that used none warms nothing)."""
        if not used_only:
            self.warmup()
            return
        used = [b for b in self.buckets if self.perf.bucket_hits.get(b.max_txns, 0) > 0]
        if used:
            self.warmup(buckets=used)

    def _split_run(self, n: int) -> List[int]:
        """Decompose a run of n same-bucket chunks into dispatchable scan
        lengths (largest built size first, singles as remainder)."""
        out: List[int] = []
        for c in sorted(self._scan_sizes, reverse=True):
            while n >= c:
                out.append(c)
                n -= c
        out.extend([1] * n)
        return out

    # -- subclass interface -------------------------------------------------
    def _dispatch_unit(self, bucket: KernelConfig, per_chunks: List[List[Dict[str, np.ndarray]]],
                       packs: Optional[List[Optional[PackSet]]] = None, sample=None):
        """Dispatch C = len(per_chunks) same-bucket chunks as ONE program
        with no host sync. `packs` gives each chunk's pack set when its
        arrays live in one (the columnar path). `sample` is the stamp of a
        sampled unit (_dispatch_sampled), or None: a sampled unit calls
        _record_device_sample once its outputs are on the host. Returns
        force() -> (status [C, T] np.ndarray, overflow bool), which blocks
        on the device. The chunks' host buffers must stay untouched until
        force() ran (columnar_dispatch releases leases inside force())."""
        raise NotImplementedError

    def _run_step(self, per_shard: List[Dict[str, np.ndarray]]) -> Tuple[np.ndarray, bool]:
        """Fused detect+fix+apply of one general-router chunk at the top
        shape (no host tier involved)."""
        status, overflow = self._dispatch_unit(self.cfg, [per_shard])()
        return status[0], overflow

    # -- sampled device timing ----------------------------------------------
    def _sample_next_dispatch(self) -> bool:
        """Deterministic 1-in-N sampling decision for the next dispatch
        unit (counter based — no rng)."""
        if not self._sample_every:
            return False
        self._dispatch_seq += 1
        return self._dispatch_seq % self._sample_every == 0

    def _sampled_unit(self, bucket: KernelConfig, per_chunks, packs=None):
        """_dispatch_unit, with the sampled fraction of units timed."""
        if not self._sample_next_dispatch():
            return self._dispatch_unit(bucket, per_chunks, packs)
        return self._dispatch_sampled(bucket, per_chunks, packs)

    def _dispatch_sampled(self, bucket: KernelConfig, per_chunks, packs=None):
        """Stamp the enqueue (wall clock, span clock, batch version) and
        dispatch the unit with it; the unit records the sample where its
        outputs land: a step unit in force(), a loop ticket where the
        drain finishes it. On the card the time is the unit's CUDA-event
        interval on the stream: its copies in, replay and copies out, and
        the time the stream idles between them while the host issues
        them (a sampled unit behind an idle stream waits on its own
        host's launches); on the CPU the wall interval from this
        stamp."""
        stamp = (time.perf_counter(), span_now() if g_spans.enabled else 0.0,
                 self._heat_version)
        return self._dispatch_unit(bucket, per_chunks, packs, sample=stamp)

    def _record_device_sample(self, bucket_txns: int, chunks: int, sample,
                              ms: Optional[float] = None) -> None:
        """File one sampled unit: `ms` as measured on the card, or (None)
        the wall interval since the stamp; with spans on, also as an
        `engine.device_time` span on the device track."""
        t0_wall, t0_span, version = sample
        if ms is None:
            ms = (time.perf_counter() - t0_wall) * 1e3
        self.perf.record_device_time(bucket_txns, ms, chunks=chunks)
        if g_spans.enabled:
            span_event("engine.device_time", version, t0_span, span_now(),
                       device_ms=round(ms, 4), bucket=bucket_txns,
                       chunks=chunks, track="device",
                       parent="resolver.queue_wait")

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

    def _device_states_for_snapshot(self):
        """Per-shard device state dicts for history_run_snapshots; None
        when this engine family keeps no host-readable state handle."""
        return None

    # -- history search mode and structure ----------------------------------
    @staticmethod
    def _resolve_history_search(cfg: KernelConfig, requested: Optional[str]) -> KernelConfig:
        """Fold the mode request into the config the ladder is built from.
        Precedence: explicit constructor argument > a non-auto
        cfg.history_search > the `resolver_history_search_mode` knob. The
        result may still be "auto": each bucket then picks its mode."""
        mode = requested
        if mode is None:
            mode = cfg.history_search
        if mode == "auto":
            mode = str(getattr(SERVER_KNOBS, "resolver_history_search_mode",
                               "auto") or "auto").strip()
        if mode not in ck.HISTORY_SEARCH_MODES:
            raise ValueError(
                f"unknown history search mode {mode!r}; expected one of "
                f"{ck.HISTORY_SEARCH_MODES}")
        if mode == cfg.history_search:
            return cfg
        return dataclasses.replace(cfg, history_search=mode)

    def history_search_modes(self) -> Dict[int, str]:
        """Resolved history-search mode per ladder bucket {T: mode} — what
        BudgetBatcher keys its per-(bucket, mode) EWMAs by."""
        return dict(self.perf.search_modes)

    @staticmethod
    def _resolve_history_structure(cfg: KernelConfig,
                                   requested: Optional[str]) -> KernelConfig:
        """Fold the history-structure request into the config the ladder
        is built from. Precedence: explicit constructor argument > a
        non-default cfg.history_structure > the
        `resolver_history_structure` knob; under the tiered structure a
        non-default cfg.history_runs wins over the `resolver_history_runs`
        knob. bucket() clones carry both into every program."""
        structure = requested
        if structure is None:
            structure = cfg.history_structure
            if structure == "monolithic":
                structure = str(getattr(SERVER_KNOBS, "resolver_history_structure",
                                        "monolithic") or "monolithic").strip()
        if structure not in ck.HISTORY_STRUCTURES:
            raise ValueError(
                f"unknown history_structure {structure!r}; expected one of "
                f"{ck.HISTORY_STRUCTURES}")
        runs = cfg.history_runs
        if structure == "tiered" and runs == KernelConfig.history_runs:
            runs = int(getattr(SERVER_KNOBS, "resolver_history_runs", runs) or runs)
        if structure == cfg.history_structure and runs == cfg.history_runs:
            ck.resolved_history_structure(cfg)  # validate run geometry
            return cfg
        cfg = dataclasses.replace(cfg, history_structure=structure, history_runs=runs)
        ck.resolved_history_structure(cfg)
        return cfg

    @property
    def history_structure(self) -> str:
        """The resolved history structure ("monolithic" | "tiered")."""
        return ck.resolved_history_structure(self.cfg)

    def history_stats_snapshot(self) -> Dict[str, Any]:
        """Tiered-history accounting as the JAX engine reports it: the
        structure and run geometry, and the run/merge counters, which the
        heat aggregator derives from each step's `runs` leaf, so they cost
        no sync; with heat off they read 0 (the serving path's own merge
        count is perf.merges)."""
        tiered = self.history_structure == "tiered"
        out = {"structure": self.history_structure,
               "run_slots": self.cfg.run_slots if tiered else 0,
               "run_rows": self.cfg.run_rows if tiered else 0,
               "appends": 0, "merges": 0, "runs_live": 0, "run_rows_live": 0}
        if self.heat is not None:
            out.update(self.heat.history_snapshot())
        return out

    # -- keyspace heat ---------------------------------------------------------
    @staticmethod
    def _resolve_heat(cfg: KernelConfig, requested: Optional[int]) -> KernelConfig:
        """Fold the heat-bucket request into the config the ladder is built
        from. Precedence: the explicit argument, then a nonzero
        cfg.heat_buckets, then the `resolver_heat_buckets` knob. bucket()
        clones carry the count into every program."""
        b = requested
        if b is None:
            b = cfg.heat_buckets or heatmap.heat_buckets_from_knobs()
        b = int(b)
        if b < 0:
            raise ValueError(f"resolver_heat_buckets must be >= 0, got {b}")
        return cfg if b == cfg.heat_buckets else dataclasses.replace(cfg, heat_buckets=b)

    def heat_snapshot(self, top_n: int = 8, brief: bool = False):
        """The keyspace-heat / occupancy fragment (heatmap.KeyRangeHeat-
        Aggregator.snapshot); None when heat is off."""
        if self.heat is None:
            return None
        return self.heat.snapshot(top_n=top_n, brief=brief)

    def _merge_heat(self, heat_host, version=None, base=None, layout: str = "") -> None:
        """Merge a forced heat subtree into the aggregator. `layout` names
        the leaves' leading axes: "" one chunk (resolve_step), "c" [C, ...]
        chunks (a scan or a loop slot's prefix), each a distinct set of
        transactions merged in order. The shard layouts of the JAX engine
        ("s", "cs", "sc") belong to the sharded engines, which the port
        does not have yet, and raise as an unknown layout does. `base` is
        the version base the batch was packed against (witness versions
        are base-relative); default: the current base."""
        if self.heat is None or heat_host is None:
            return
        if base is None:
            base = self.base
        if layout == "":
            self.heat.merge({k: np.asarray(v) for k, v in heat_host.items()},
                            base=base, version=version)
        elif layout == "c":
            for c in range(np.asarray(heat_host["bounds"]).shape[0]):
                self._merge_heat({k: np.asarray(v)[c] for k, v in heat_host.items()},
                                 version, base, "")
        else:
            raise ValueError(f"unknown heat layout {layout!r}")

    def history_run_snapshots(self, since_runs: Optional[Sequence[int]] = None):
        """Per-shard tiered run snapshots (ck.history_run_snapshot), the
        O(delta) export: `since_runs` is the per-shard run watermark of the
        previous snapshot; a snapshot whose nruns fell below it means a
        merge compacted the stack and the consumer must resync. None for
        monolithic engines."""
        if self.history_structure != "tiered":
            return None
        states = self._device_states_for_snapshot()
        if states is None:
            return None
        return [ck.history_run_snapshot(self.cfg, st,
                                        since_runs=0 if since_runs is None else int(since_runs[s]))
                for s, st in enumerate(states)]

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
        read_conflict_ranges, write_conflict_ranges and read_snapshot. The
        columnar path takes the batch when every range is a short-key point
        row; else the general router does."""
        if transactions:
            res = self._resolve_columnar(transactions, now, new_oldest)
            if res is not None:
                return res
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

    def _resolve_columnar(self, transactions: Sequence[Any], now: Version,
                          new_oldest: Version) -> Optional[List[TransactionCommitResult]]:
        """Columnar fast path = pack + dispatch + force, in one call."""
        plan = self.columnar_pack(transactions, now, new_oldest)
        if plan is None:
            return None
        return self.columnar_dispatch(plan)()

    def columnar_pack(self, transactions: Sequence[Any], now: Version,
                      new_oldest: Version) -> Optional[dict]:
        """Host half of the columnar fast path over conflict-wire blocks:
        when every range is a short-key POINT row, batch assembly is two
        native passes + numpy (no per-range Python). Point reads of
        in-window keys never couple with the host long-key tier (keypack.py:
        short-key membership is device-exact), so the fused step is always
        safe here. Host numpy and C only: it touches no CUDA state, so the
        pipeline runs it on an executor thread.

        Returns an opaque plan for columnar_dispatch, or None when the
        preconditions fail (the general router must handle the batch).
        Mutates NO engine state, but the packed arrays embed base-relative
        versions: the matching columnar_dispatch must run before any LATER
        batch packs (the ResolverPipeline keeps this ordering)."""
        cfg = self.cfg
        ntx = len(transactions)
        if ntx == 0 or self.n_shards != 1:
            return None                 # the sharded passes are a later slice
        t_pack = span_now() if g_spans.enabled else 0.0
        blocks = []
        for tr in transactions:
            info = getattr(tr, "conflict_wire_info", None)
            blk, all_point, max_len = (info() if info is not None else wire.conflict_wire_ex(
                tr.read_conflict_ranges, tr.write_conflict_ranges))
            if not all_point or max_len > self._window:
                return None             # early out: later txns are not even encoded
            blocks.append(blk)
        p1 = wire_pass1(self._window, blocks)
        if p1 is None:
            return None
        blob, offs, rp_cnt, wp_cnt = p1
        if int(rp_cnt.max()) > cfg.rp or int(wp_cnt.max()) > cfg.wp:
            raise error.client_invalid_operation(
                "single transaction exceeds device conflict-range capacity")
        snaps = np.fromiter((tr.read_snapshot for tr in transactions), np.int64, count=ntx)
        rel = snaps - self.base
        if int(rel.max()) >= 2**30 or now - self.base >= 2**30:
            raise error.client_invalid_operation(
                f"version too far beyond base {self.base} for int32 device window")
        snap_rel = np.maximum(rel, -1).astype(np.int32)
        too_old = (snaps < self.oldest_version) & (rp_cnt > 0)
        skip = too_old.astype(np.uint8)
        eff_r = np.where(too_old, 0, rp_cnt).astype(np.int32)
        eff_w = np.where(too_old, 0, wp_cnt).astype(np.int32)
        cr = np.cumsum(eff_r)
        cw = np.cumsum(eff_w)

        now_rel = self._rel(now)
        #: (per_shard_arrays, n_txns, bucket_cfg, arena_lease, pack_set) per chunk
        chunks: List[Tuple[List[Dict[str, np.ndarray]], int, KernelConfig,
                           Optional[ArenaLease], PackSet]] = []
        i = 0
        while i < ntx:
            r0 = int(cr[i - 1]) if i else 0
            w0 = int(cw[i - 1]) if i else 0
            j = min(i + cfg.max_txns, ntx,
                    int(np.searchsorted(cr, r0 + cfg.rp, side="right")),
                    int(np.searchsorted(cw, w0 + cfg.wp, side="right")))
            j = max(j, i + 1)           # a single txn always fits (checked above)
            last = j >= ntx
            gc_rel = self._rel(new_oldest) if last and new_oldest > self.oldest_version else 0
            bucket = self.bucket_for(j - i, int(cr[j - 1]) - r0, int(cw[j - 1]) - w0)
            lease = None
            if self.arena is not None:
                bufs, lease = self.arena.lease(bucket)
                pack = lease.pack
            else:
                bufs, pack = fresh_bufs(bucket)
            per = [wire_chunk_arrays(bucket, blob, offs, i, j, skip, snap_rel, eff_r,
                                     now_rel, gc_rel, bufs=bufs)]
            chunks.append((per, j - i, bucket, lease, pack))
            i = j
        if g_spans.enabled:
            # the host-pack segment, keyed by the batch's commit version
            # like every other commit-path span
            span_event("engine.host_pack", now, t_pack, span_now(), txns=ntx,
                       parent="resolver.queue_wait")
        return {"chunks": chunks, "new_oldest": new_oldest, "now": now,
                "chunk_buckets": [c[2].max_txns for c in chunks]}

    def columnar_dispatch(self, plan: dict):
        """Device half of the columnar fast path: group consecutive
        same-bucket chunks into chunk-scan units (one program threading the
        table through C chunks), dispatch every unit with no host sync, and
        advance the host version bookkeeping. Returns force() ->
        List[TransactionCommitResult], which blocks on the device.

        The ResolverPipeline keeps several dispatched batches in flight and
        forces them in commit-version order, so abort sets are identical to
        the serial resolve() path (the programs run in the same order on the
        one stream either way). One observable difference: a boundary-table
        overflow raises at force() time, after any later chunks of the SAME
        batch were already dispatched (the general router stops at the
        overflowing chunk); overflow is a fatal capacity error in both
        cases."""
        chunks = plan["chunks"]
        loop_mode = self.dispatch_mode == "loop"
        #: the batch version heat attribution carries: each unit captures
        #: it at dispatch
        self._heat_version = plan.get("now")
        t_enq = span_now() if g_spans.enabled else 0.0
        #: (unit_force, [n_txns per chunk], [leases per chunk], flight record)
        outs: List[Tuple[Callable, List[int], List[Optional[ArenaLease]], dict]] = []
        i = 0
        while i < len(chunks):
            bucket = chunks[i][2]
            j = i
            while j < len(chunks) and chunks[j][2] is bucket:
                j += 1
            run = chunks[i:j]
            self.perf.bucket_hits[bucket.max_txns] = (
                self.perf.bucket_hits.get(bucket.max_txns, 0) + len(run))
            self.perf.record_search_mode(bucket.max_txns, len(run))
            self.perf.record_dispatch_mode(self.dispatch_mode, len(run))
            for c in self._split_run(len(run)):
                sub, run = run[:c], run[c:]
                unit = self._sampled_unit(bucket, [ch[0] for ch in sub], [ch[4] for ch in sub])
                self.perf.scan_dispatches[c] = self.perf.scan_dispatches.get(c, 0) + 1
                rec = self.perf.record_dispatch(bucket.max_txns, c, sum(ch[1] for ch in sub))
                outs.append((unit, [ch[1] for ch in sub], [ch[3] for ch in sub], rec))
            i = j
        self._heat_version = None
        version = plan.get("now")
        if g_spans.enabled and loop_mode:
            # the loop engine's dispatch only filled queue slots and
            # enqueued their programs: the queue_enqueue segment
            span_event("engine.queue_enqueue", version, t_enq, span_now(),
                       units=len(outs), parent="resolver.queue_wait")
        new_oldest = plan["new_oldest"]
        if new_oldest > self.oldest_version:
            self.tier_map.gc(new_oldest)
            self.oldest_version = new_oldest
            self.base += max(0, new_oldest - self.base)
        capacity = self.cfg.capacity

        def force() -> List[TransactionCommitResult]:
            t_force = span_now() if g_spans.enabled else 0.0
            results: List[TransactionCommitResult] = []
            for unit, ns, leases, rec in outs:
                t_unit = time.perf_counter()
                status, overflow = unit()
                # the flight record completes when the unit's outputs land
                rec["force_ms"] = round((time.perf_counter() - t_unit) * 1e3, 4)
                if overflow:
                    raise error.conflict_capacity_exceeded(
                        f"a shard's boundary table needs > {capacity} rows")
                for c, n in enumerate(ns):
                    self.perf.record_verdicts(status[c, :n])
                    results.extend(TransactionCommitResult(int(v)) for v in status[c, :n])
                # the unit's copies are done: its buffers may be reused
                for lease in leases:
                    if lease is not None:
                        lease.release()
            if g_spans.enabled:
                # the readback segment: a step engine waits on its units'
                # events here, a loop engine drains its result ring and
                # attaches its loop_stats snapshot; the heat brief rides
                # along, so a slow batch's trace says whether the keyspace
                # was hot. Host values only: no device read.
                extra = {}
                if loop_mode:
                    extra["loop_stats"] = self.loop_stats_snapshot()
                if self.heat is not None:
                    extra["heat"] = self.heat.brief()
                span_event("engine.result_drain" if loop_mode else "engine.force",
                           version, t_force, span_now(), units=len(outs), **extra)
            return results

        return force

    def _resolve_chunk(self, routed: Sequence[_RoutedTxn], now: Version,
                       new_oldest: Version) -> List[TransactionCommitResult]:
        cfg = self.cfg
        S = self.n_shards
        n = len(routed)
        if n > cfg.max_txns:
            raise ValueError(f"chunk of {n} txns exceeds max_txns={cfg.max_txns}")
        # general-router chunks always run the top shape; count their mode
        # picks so the telemetry counters cover this path too
        self.perf.record_search_mode(cfg.max_txns, 1)
        self.perf.record_dispatch_mode(self.dispatch_mode, 1)
        self._heat_version = now

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
            self.perf.record_verdicts(status[:n])
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
        self.perf.record_verdicts(status[:n])
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


class _Program:
    """One (bucket, C) program: C steps of the bucket's shapes over the
    engine's static state, reading static [C, ...] input tensors, one per
    batch field (input_shapes), and writing static status [C, T] /
    overflow [C] buffers.

    On the card it is up to two captured CUDA graphs, one per answer to
    "does the last chunk carry gc > 0" (JAX's lax.cond on the device
    scalar; only a batch's last chunk carries its GC horizon). The graphs
    end by copying the new table into the engine's static state buffers,
    which every bucket shares: the table has the same shape in all. Under
    the tiered structure each step's lazy merge is a conditional IF node
    (ck.run_if, graph_if) whose body replays only when the run stack is
    full; its body is captured on the engine's body stream into its body
    pool; the program also writes each step's `merged` flag [C]. With heat
    on it writes each step's heat aggregate into static [C, ...] buffers
    (`heat`, ck.heat_shapes). On the CPU the program runs resolve_step_scan
    eagerly on the same buffers."""

    def __init__(self, engine: "TorchConflictEngine", bucket: KernelConfig, C: int):
        dev = engine.device
        self.engine = engine
        self.bucket, self.C = bucket, C
        self.inputs = {name: torch.zeros((C,) + shape, dtype=dtype, device=dev)
                       for name, (shape, dtype) in input_shapes(bucket).items()}
        self.status = torch.zeros((C, bucket.max_txns), dtype=torch.int32, device=dev)
        self.overflow = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.merged = (torch.zeros((C,), dtype=torch.bool, device=dev)
                       if ck.is_tiered(bucket) else None)
        self.heat = {k: torch.zeros((C,) + shape, dtype=dtype, device=dev)
                     for k, (shape, dtype) in ck.heat_shapes(bucket).items()}
        #: chunk slots whose range rows a general-router chunk wrote
        self.cold_dirty = [False] * C
        self.graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        #: fixpoint kernels one replay launches (counted at capture)
        self.launches = 0
        if dev.type == "cuda":
            for gc_last in (False, True):
                self._capture(gc_last)

    def batches(self) -> Dict[str, torch.Tensor]:
        """The step's batch dict, leaves [C, ...], over the static inputs:
        the tensors themselves, except the keys, which widen to int64 by
        zero extension (inside a captured graph, at every replay)."""
        return {name: (v.to(torch.int64) & _KEY_MASK) if name in ck.KEY_FIELDS else v
                for name, v in self.inputs.items()}

    def _body(self, state: Dict[str, torch.Tensor], gc_last: bool,
              batches: Optional[Dict[str, torch.Tensor]] = None) -> None:
        new_state, out = ck.resolve_step_scan(
            self.bucket, state, self.batches() if batches is None else batches, gc_last)
        for k, v in state.items():
            v.copy_(new_state[k])
        self.status.copy_(out["status"])
        self.overflow.copy_(out["overflow"])
        if self.merged is not None:
            self.merged.copy_(out["merged"])
        for k, v in self.heat.items():
            v.copy_(out["heat"][k])

    def _merge_warm_batches(self) -> Dict[str, torch.Tensor]:
        """The static inputs with one committed point write in chunk 0, so
        that a step on a full run stack takes the merge branch."""
        b = {k: v.clone() for k, v in self.batches().items()}
        b["t_ok"][0, 0] = True
        b["t_too_old"][0, 0] = False
        b["wp_valid"][0, 0] = True
        b["wp_txn"][0, 0] = 0
        return b

    def _capture(self, gc_last: bool) -> None:
        """Capture one variant. An eager run on a scratch copy of the table
        comes first, on the capture stream: it does what must not happen
        under capture (the fixpoint's one-time cluster occupancy query,
        library handles, a kernel's first load). Under the tiered structure
        it runs both sides of the merge branch: once as the table stands
        and once on a full run stack with a write-bearing chunk, since the
        IF node's body is captured whatever its predicate. A capture that
        fails raises; nothing falls back to the eager step."""
        eng = self.engine
        stream = eng.capture_stream
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            scratch = {k: v.clone() for k, v in eng.state.items()}
            self._body(scratch, gc_last)
            if self.merged is not None:
                scratch["nruns"].fill_(self.bucket.run_slots)
                self._body(scratch, gc_last, self._merge_warm_batches())
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = fixpoint_cuda.FIXPOINT.launches
        if_before = graph_if.GRAPH_IF.nodes
        with graph_if.bodies(eng.body_levels[:1]), \
                torch.cuda.graph(graph, pool=eng.graph_pool, stream=stream,
                                 capture_error_mode="relaxed"):
            self._body(eng.state, gc_last)
        launches = fixpoint_cuda.FIXPOINT.launches - before
        if launches != self.C:
            raise RuntimeError(f"captured {launches} fixpoint launches in a {self.C}-step graph")
        if_nodes = graph_if.GRAPH_IF.nodes - if_before
        if if_nodes != (self.C if self.merged is not None else 0):
            raise RuntimeError(f"captured {if_nodes} merge IF nodes in a {self.C}-step graph")
        self.launches = launches
        self.graphs[gc_last] = graph
        eng.perf.captures += 1

    def load(self, c: int, arrays: Dict[str, np.ndarray], pack: Optional[PackSet]) -> None:
        """Copy chunk c into the static inputs, stream-ordered, one copy a
        field: a pack set's hot fields from its tensors (the range rows
        are zero on the columnar path, and stay zero in the static inputs
        unless a general-router chunk wrote them), or every field of any
        other batch dict."""
        if pack is not None:
            src = pack.tensors
            if self.cold_dirty[c]:
                for name in COLD_FIELDS:
                    self.inputs[name][c].zero_()
                self.cold_dirty[c] = False
        else:
            src = host_tensors(self.bucket, arrays)
            self.cold_dirty[c] = True
        for name, t in src.items():
            self.inputs[name][c].copy_(t, non_blocking=True)

    def run(self, gc_last: bool) -> None:
        if self.graphs:
            self.graphs[gc_last].replay()
            fixpoint_cuda.FIXPOINT.graph_launches += self.launches
        else:
            self._body(self.engine.state, gc_last)


class TorchConflictEngine(RoutedConflictEngineBase):
    """Single-card ConflictSet engine backed by the torch conflict step and
    the CUDA fixpoint kernel (one shard). Same resolve() contract as
    OracleConflictEngine. `device=None` means the card, and raises where
    there is none; `device="cpu"` runs the same programs eagerly on the
    CPU, with the plain fixpoint.

    The interval table lives in static buffers (`state`) that every
    program reads and writes in place: anything that sets the table copies
    into them, so a captured graph never reads a dead table."""

    name = "torch"

    def __init__(self, cfg: KernelConfig = KernelConfig(), initial_version: Version = 0,
                 device=None, ladder: Optional[Sequence[int]] = None,
                 scan_sizes: Sequence[int] = (2, 4, 8), arena: bool = True,
                 history_search: Optional[str] = None,
                 heat_buckets: Optional[int] = None,
                 device_time_sample_rate: Optional[float] = None,
                 history_structure: Optional[str] = None):
        device = _default_device(device)
        self.device = device
        super().__init__(cfg, KeyShardMap([]), ladder=ladder, scan_sizes=scan_sizes,
                         arena=arena, pin_memory=device.type == "cuda",
                         history_search=history_search, heat_buckets=heat_buckets,
                         device_time_sample_rate=device_time_sample_rate,
                         history_structure=history_structure)
        self.state = ck.initial_state(self.cfg, version_rel=initial_version, device=device)
        self.tier_map = VersionIntervalMap(initial_version)
        if device.type == "cuda":
            #: one memory pool for every graph: replays are serialized on
            #: one stream, the table ends in the static buffers and outputs
            #: are copied out before the next replay
            self.graph_pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(device)
            #: where conditional-node bodies are captured, one (stream,
            #: private pool) per nesting level (graph_if): the tiered merge's
            #: IF node at level 0 in a step program; in the loop engine's
            #: programs the WHILE body at level 0 and the IF node in it at 1
            self.body_levels = [(torch.cuda.Stream(device), torch.cuda.graph_pool_handle())
                                for _ in range(2)]

    def _set_state(self, new: Dict[str, torch.Tensor]) -> None:
        for k, v in self.state.items():
            v.copy_(new[k])

    def _reset_device_state(self, version_rel: int) -> None:
        self._set_state(ck.initial_state(self.cfg, version_rel=version_rel, device=self.device))

    def _device_states_for_snapshot(self):
        return [self.state]

    def load_state(self, state_np: Dict[str, np.ndarray], base: Version,
                   oldest_version: Version, tier_map=None) -> None:
        """Adopt another engine's interval table mid-stream: numpy
        {"hkeys", "hvers", "n"} (base-relative versions), with the run
        planes {"rkeys", "rvers", "rn", "nruns"} under the tiered
        structure, its version base and GC horizon, and optionally its host
        long-key tier (any object with `keys` / `vers` lists)."""
        self._set_state(ck.state_from_numpy(self.cfg, state_np, self.device))
        self.base = base
        self.oldest_version = oldest_version
        self.tier_map = VersionIntervalMap(0)
        if tier_map is not None:
            self.tier_map.keys = list(tier_map.keys)
            self.tier_map.vers = list(tier_map.vers)
        self._tier_has_writes = len(self.tier_map) > 1

    def _make_program(self, bucket: KernelConfig, n_chunks: int) -> _Program:
        return _Program(self, bucket, n_chunks)

    def _measured_build(self, build):
        """On the card: the peak device memory allocated during the build
        (static buffers, the warm run's scratch table, the captures'
        temporaries) above what was allocated when it began. Reading the
        allocator's counters is host bookkeeping: no sync. The reading
        resets the process's peak counter (torch.cuda.max_memory_allocated)
        at every build, and the allocator cannot restore it: a caller that
        reads that counter over a window holding a build (a warmup, or a
        steady-state build) gets the peak since the build began."""
        if self.device.type != "cuda":
            return build(), None
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        prog = build()
        return prog, torch.cuda.max_memory_allocated(self.device) - before

    def _dispatch_unit(self, bucket: KernelConfig, per_chunks: List[List[Dict[str, np.ndarray]]],
                       packs: Optional[List[Optional[PackSet]]] = None, sample=None):
        C = len(per_chunks)
        gcs = [int(per[0]["gc"]) for per in per_chunks]
        if any(gcs[:-1]):
            raise ValueError("only the last chunk of a dispatch unit may carry a GC horizon")
        prog = self._program(bucket, C)
        timing = None
        if sample is not None and self.device.type == "cuda":
            # a sampled unit on the card: its stream interval from before
            # its first copy in to after its last copy out (device work and
            # the stream's idle time while this thread issues it), read
            # once the unit is done
            timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timing[0].record()
        for c, (arrays,) in enumerate(per_chunks):
            prog.load(c, arrays, packs[c] if packs else None)
        prog.run(gcs[-1] > 0)
        heat_base, heat_version = self.base, self._heat_version
        if self.device.type == "cpu":
            result = (prog.status.numpy().copy(), bool(prog.overflow.any()),
                      {k: v.numpy().copy() for k, v in prog.heat.items()})
            if prog.merged is not None:
                self.perf.merges += int(prog.merged.sum())

            def read():
                if sample is not None:
                    self._record_device_sample(bucket.max_txns, C, sample)
                return result
        else:
            # every output to pinned host memory, behind one event
            outs = {"status": prog.status, "overflow": prog.overflow, **prog.heat}
            if prog.merged is not None:
                outs["merged"] = prog.merged
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in outs.items()}
            for k, v in outs.items():
                host[k].copy_(v, non_blocking=True)
            if timing is not None:
                timing[1].record()
            done = torch.cuda.Event()
            done.record()
            keep = (per_chunks, packs)

            def read():
                done.synchronize()
                _ = keep        # the host buffers live until the copies ran
                if timing is not None:
                    self._record_device_sample(bucket.max_txns, C, sample,
                                               ms=timing[0].elapsed_time(timing[1]))
                if "merged" in host:
                    self.perf.merges += int(host["merged"].numpy().sum())
                return (host["status"].numpy(), bool(host["overflow"].numpy().any()),
                        {k: host[k].numpy() for k in prog.heat})

        def force() -> Tuple[np.ndarray, bool]:
            status, overflow, heat = read()
            if heat:
                self._merge_heat(heat, version=heat_version, base=heat_base, layout="c")
            return status, overflow

        return force

    def _batch(self, per_shard) -> Dict:
        (arrays,) = per_shard
        return ck.batch_from_numpy(self.cfg, arrays, self.device)

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
        new_state, overflow, _, merged = ck._apply_writes(
            self.cfg, self.state, batch, cm, ctx["wpos"], gc_branch=int(per_shard[0]["gc"]) > 0)
        self._set_state(new_state)
        if merged is not None:
            self.perf.merges += int(merged)
        status = ck.status_of(batch["t_too_old"], cm)
        return status.cpu().numpy(), bool(overflow)


#: the engine-mode router: "torch" (single card, step dispatch) and
#: "device_loop" (single card, the device-resident server loop;
#: ops/device_loop.py)
ENGINE_MODES = ("torch", "device_loop")


def default_engine_mode() -> str:
    """The single-card mode the `resolver_device_loop` knob selects:
    "device_loop" when the knob is set, else "torch" (step dispatch)."""
    from .device_loop import device_loop_requested

    return "device_loop" if device_loop_requested() else "torch"


def make_engine(mode: str, cfg: KernelConfig, **kw):
    """Registry entry point: build the engine family `mode` names."""
    if mode == "torch":
        return TorchConflictEngine(cfg, **kw)
    if mode == "device_loop":
        from .device_loop import DeviceLoopEngine

        return DeviceLoopEngine(cfg, **kw)
    raise ValueError(f"unknown engine mode {mode!r}; expected one of {ENGINE_MODES}")
